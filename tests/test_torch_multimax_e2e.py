"""The K-max CE end to end on the CPU: forward, then backward on that lse.

On the card K5f and K5b's launch P compute z by one routine, float32 fmaf
chains over the dims in order, so the gradients taken on K5f's lse are held
to the plain backward taken on the plain lse (``chip_smoke.check_multimax``'s
end-to-end gate).  Here the port's ``multimax_lse`` and ``multimax_grads``
run their plain versions (the tensors lie on the CPU) and are held, on
seeded numpy inputs, to the JAX package's (its Pallas K5f and K5b in
interpret mode, at highest precision), each side's backward on its own
forward's lse: lse within 1e-5 of its largest entry, du and d_items within
1e-5 of each array's largest entry.  The port's k* differs from float64's
only at near-ties (``chip_smoke.mm_key_flips``' bound, twice float32's
rounding of a D-term dot product), and with all interests equal interest 0
takes every item.  The CUDA launches run only on the card
(``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.ops.kernels import multimax_ce as jmm
from rec_pangu_tpu_torch.ops.kernels import multimax_ce as mm

REL_TOL = 1e-5  # of each array's largest entry (chip_smoke.MM_REL_TOL)


def _inputs(seed, B, K, D, rows, ties=False):
    """u [B, K, D] and items [rows, D]; with ``ties`` every interest repeats
    interest 0."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((B, K, D)) * 0.5).astype(np.float32)
    if ties:
        u[:, 1:] = u[:, :1]
    items = rng.standard_normal((rows, D)).astype(np.float32)
    return torch.from_numpy(u), torch.from_numpy(items)


def _jax_table(items, zero_row0):
    """The table padded to whole 128-row tiles (the JAX kernels' tiling needs
    them), row 0 zeroed for ``zero_row0``."""
    rows = items.shape[0]
    table = np.zeros((-(-rows // 128) * 128, items.shape[1]), np.float32)
    table[:rows] = items.numpy()
    if zero_row0:
        table[0] = 0.0
    return jnp.asarray(table)


def _jax_forward_backward(u, items, valid_v, zero_row0):
    """(lse, du, d_items [rows]) of the JAX package's K5f, then K5b on its lse."""
    table, ju = _jax_table(items, zero_row0), jnp.asarray(u.numpy())
    with jax.default_matmul_precision("highest"):
        lse = jmm.multimax_lse(ju, table, valid_v, interpret=True)
        du, d_items = jmm.multimax_grads(ju, table, lse, valid_v, interpret=True)
    return np.asarray(lse), np.asarray(du), np.asarray(d_items)[:items.shape[0]]


def _assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


def _live(B, rows, valid_v, zero_row0):
    live = torch.zeros(B, rows, dtype=torch.bool)
    live[:, :valid_v] = True
    if zero_row0:
        live[:, 0] = False
    return live


# (K, D, rows, valid_v, zero_row0): K 1/3/4 by D 24/64/128, odd item counts,
# valid_v inside the table or at its end, row 0 read as zero or not
CASES = [(k, d, rows, valid, z0)
         for (k, d), (rows, valid, z0) in zip(
             [(k, d) for k in (1, 3, 4) for d in (24, 64, 128)],
             [(1001, 999, True), (517, 517, False), (333, 301, True), (1001, 1001, False),
              (517, 400, True), (333, 333, False), (1001, 900, False), (517, 517, True),
              (333, 257, True)])]


@pytest.mark.parametrize("K,D,rows,valid_v,zero_row0", CASES)
def test_lse_matches_jax(K, D, rows, valid_v, zero_row0):
    u, items = _inputs(K * 1000 + D + rows, 12, K, D, rows)
    lse = mm.multimax_lse(u, items, valid_v, zero_row0)
    want, _, _ = _jax_forward_backward(u, items, valid_v, zero_row0)
    _assert_close(lse, want)


@pytest.mark.parametrize("K,D,rows,valid_v,zero_row0", CASES)
def test_grads_on_the_forward_lse_match_jax(K, D, rows, valid_v, zero_row0):
    """Each side's backward on its own forward's lse: an error of the
    forward's lse scales every p, so this holds the forward to the
    backward's tolerance too."""
    u, items = _inputs(K * 31 + D + rows, 12, K, D, rows)
    lse = mm.multimax_lse(u, items, valid_v, zero_row0)
    du, d_items = mm.multimax_grads(u, items, lse, valid_v, zero_row0)
    _, want_du, want_di = _jax_forward_backward(u, items, valid_v, zero_row0)
    _assert_close(du, want_du)
    row = 1 if zero_row0 else 0  # JAX gives the zero row 0 a gradient; the port none
    _assert_close(d_items[row:], want_di[row:])
    assert not d_items[valid_v:].any()
    if zero_row0:
        assert not d_items[0].any()


@pytest.mark.parametrize("K,D,rows,valid_v,zero_row0", CASES)
def test_keys_flip_only_at_near_ties(K, D, rows, valid_v, zero_row0):
    """k* of the port's float32 scores against float64's: every pair that
    differs is a near-tie, and each score lies within float32's rounding
    bound of a D-term dot product (D 2^-24 of sum_d |u_d item_d|)."""
    B = 48
    u, items = _inputs(K * 7 + D + rows, B, K, D, rows)
    lse = mm.multimax_lse(u, items, valid_v, zero_row0)
    p, ks, _ = mm.pairs_reference(u, items, 0, lse, valid_v, zero_row0)
    exact = torch.einsum("bkd,vd->bkv", u.double(), items.double())
    scale = torch.einsum("bkd,vd->bkv", u.abs().double(), items.abs().double())
    ks_exact = exact.argmax(1)
    live = _live(B, rows, valid_v, zero_row0)
    b, v = ((ks.long() != ks_exact) & live).nonzero(as_tuple=True)
    ka, kb = ks[b, v].long(), ks_exact[b, v]
    bound = 2 * D * 2.0 ** -24 * torch.maximum(scale[b, ka, v], scale[b, kb, v])
    assert bool(((exact[b, ka, v] - exact[b, kb, v]).abs() <= bound).all())
    # p = exp(z - lse): z of the winning interest within float32's bound
    z = torch.log(p.double()) + lse.double()[:, None]
    best = exact.amax(1)
    assert bool(((z - best).abs()[live] <= 2 * D * 2.0 ** -24 * scale.amax(1)[live]
                 + 4 * 2.0 ** -24 * lse.double().abs().amax()).all())


@pytest.mark.parametrize("D", [24, 64, 128])
def test_ties_go_to_interest_zero(D):
    u, items = _inputs(D, 16, 4, D, 700, ties=True)
    lse = mm.multimax_lse(u, items, 650, True)
    _, ks, _ = mm.pairs_reference(u, items, 0, lse, 650, True)
    assert not ks.any()
    du, d_items = mm.multimax_grads(u, items, lse, 650, True)
    assert not du[:, 1:].any() and bool(du[:, 0].any())
    _, want_du, want_di = _jax_forward_backward(u, items, 650, True)
    _assert_close(du, want_du)
    _assert_close(d_items[1:], want_di[1:])


def test_pairs_sum_to_one_against_the_forward_lse():
    """P's p = exp(z - lse), with the forward's lse, over a table of several
    chunks: every item's p, with row 0's share, sums to 1 within float32
    roundings."""
    u, items = _inputs(3, 20, 4, 64, 3001)
    lse = mm.multimax_lse(u, items, 2990, True)
    total = torch.zeros(20, dtype=torch.float64)
    for base in range(0, 3001, 1024):
        p, _, _ = mm.pairs_reference(u, items[base:base + 1024], base, lse, 2990, True)
        total += p.double().sum(1)
    total += torch.exp(-lse).double()  # row 0 scores 0: in the denominator, no gradient
    assert bool(((total - 1).abs() < 1e-5).all())
