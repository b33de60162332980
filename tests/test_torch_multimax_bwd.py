"""K5b's chunked decomposition (the port's K-max CE backward) on the CPU.

The chunk plan (``grads_plan``) covers every row once in chunks of whole
128-item tiles and keeps the workspace (p, k* and the du partials) under
its budget whatever the table's rows.  The staged plain version (p and k*
of each chunk, du summed chunk by chunk, d_items from p and k*) is held
to the plain version at its default chunk and to the JAX package's
``multimax_grads`` run in interpret mode at highest precision, on seeded
numpy inputs: each gradient within rtol 1e-5 and an atol of 1e-5 times its
largest entry (float32 sums in other orders).  The JAX kernel reads row 0
as the zero vector it is given and gives it a gradient; the port's
``zero_row0`` gives it none, so row 0 of d_items is compared apart.  The
CUDA launches run only on the card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.ops.kernels import multimax_ce as jmm
from rec_pangu_tpu_torch.ops.kernels import multimax_ce as mm

BENCH = (1024, 4, 64, 1_007_616)


def _inputs(seed, B, K, D, rows, ties=False):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((B, K, D)) * 0.5).astype(np.float32)
    if ties:  # interests 1 and 2 repeat 0: every item ties between them
        u[:, 1:3] = u[:, :1]
    items = rng.standard_normal((rows, D)).astype(np.float32)
    return torch.from_numpy(u), torch.from_numpy(items)


def _close(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def _staged(u, items, lse, valid_v, zero_row0, chunk):
    """The kernels' decomposition in plain PyTorch, chunk by chunk of
    ``chunk`` items: p, k* and du of the chunk (``pairs_reference``), du
    added in chunk order, d_items rows from p and k* (``items_reference``)."""
    du = torch.zeros_like(u)
    d_items = torch.empty_like(items)
    for base in range(0, items.shape[0], chunk):
        c = items[base:base + chunk]
        p, ks, du_chunk = mm.pairs_reference(u, c, base, lse, valid_v, zero_row0)
        du += du_chunk
        d_items[base:base + c.shape[0]] = mm.items_reference(u, p, ks)
    return du, d_items


def _jax_grads(u, items, lse, valid_v, zero_row0):
    table = items.numpy().copy()
    if zero_row0:
        table[0] = 0.0
    with jax.default_matmul_precision("highest"):
        du, di = jmm.multimax_grads(jnp.asarray(u.numpy()), jnp.asarray(table),
                                    jnp.asarray(lse.numpy()), valid_v, interpret=True)
    return np.asarray(du), np.asarray(di)


@pytest.mark.parametrize("shape", [BENCH, (128, 4, 64, 100_352), (3, 4, 64, 1001),
                                   (37, 3, 24, 5000), (1, 1, 1, 1)])
@pytest.mark.parametrize("budget", [None, 1 << 20, 1])
def test_plan_covers_every_row_once_in_whole_tiles(shape, budget):
    B, K, D, rows = shape
    plan = mm.grads_plan(B, K, D, rows) if budget is None else mm.grads_plan(B, K, D, rows,
                                                                              budget)
    tiles = -(-rows // mm.ITEM_TILE)
    assert plan.chunk_items % mm.ITEM_TILE == 0 and plan.chunk_tiles >= 1
    assert (plan.chunks - 1) * plan.chunk_tiles < tiles <= plan.chunks * plan.chunk_tiles
    assert 1 <= plan.tiles_per_split <= plan.chunk_tiles
    assert plan.splits == -(-plan.chunk_tiles // plan.tiles_per_split)
    pairs = B * plan.chunk_items
    assert plan.words == pairs + pairs // 4 + plan.splits * B * K * D


@pytest.mark.parametrize("rows", [100_352, 1_007_616, 10_000_128, 100_000_000])
def test_plan_keeps_the_workspace_under_its_budget(rows):
    B, K, D, _ = BENCH
    plan = mm.grads_plan(B, K, D, rows)
    assert plan.words * 4 <= mm.WORKSPACE_BUDGET
    small = 64 << 20
    assert mm.grads_plan(B, K, D, rows, small).words * 4 <= small


@pytest.mark.parametrize("shape", [(128, 4, 64, 100_352), (3, 4, 64, 1001), (64, 2, 64, 1)])
def test_plan_is_one_chunk_when_the_workspace_fits(shape):
    plan = mm.grads_plan(*shape)
    assert plan.chunks == 1 and plan.chunk_tiles == -(-shape[3] // mm.ITEM_TILE)


def test_plan_at_the_bench_shape():
    plan = mm.grads_plan(*BENCH)
    assert (plan.chunks, plan.chunk_tiles, plan.tiles_per_split, plan.splits) == (5, 1575, 48, 33)
    assert plan.words * 4 < 1 << 30
    assert mm.grads_plan(*BENCH, budget=1 << 62).chunks == 1


def test_workspace_views_lay_p_keys_and_partials_apart():
    B, K, D = 5, 3, 8
    plan = mm.grads_plan(B, K, D, 300)
    work = torch.zeros(plan.words)
    p, ks, partial = mm.workspace_views(work, B, K, D, plan)
    assert p.shape == ks.shape == (B, plan.chunk_items) and ks.dtype == torch.uint8
    assert partial.shape == (plan.splits, B, K, D)
    ks.fill_(3)
    partial.fill_(2.0)
    assert not p.any() and bool((work[p.numel():p.numel() + ks.numel() // 4] != 0).all())
    assert int((work == 2.0).sum()) == partial.numel()


def test_pairs_reference_masks_padding_and_row0():
    u, items = _inputs(1, 6, 3, 16, 500)
    lse = mm.multimax_lse_reference(u, items, 450, True)
    p, ks, du = mm.pairs_reference(u, items[:256], 0, lse, 450, True)
    assert p.dtype == torch.float32 and ks.dtype == torch.uint8 and p.shape == (6, 256)
    assert not p[:, 0].any() and bool((p[:, 1:] > 0).all()) and int(ks.max()) <= 2
    p, _, _ = mm.pairs_reference(u, items[256:], 256, lse, 450, True)
    assert not p[:, 450 - 256:].any() and bool((p[:, :450 - 256] > 0).all())
    assert du.shape == u.shape


# (B, K, D, rows, valid_v, zero_row0, chunk items, ties)
CASES = [
    (8, 4, 16, 1024, 1000, True, 384, False),    # chunks of 3 tiles, valid inside a tile
    (8, 4, 16, 1024, 768, False, 384, False),    # valid_v on a chunk boundary
    (8, 4, 16, 1024, 1000, True, 200, False),    # chunks that split inside a tile
    (8, 4, 16, 1024, 1024, True, 256, True),     # ties: the lowest interest takes all
    (8, 1, 16, 640, 600, True, 256, False),      # K = 1
    (8, 3, 24, 1024, 1000, False, 128, False),   # K = 3, D = 24, one tile a chunk
]


@pytest.mark.parametrize("B,K,D,rows,valid_v,zero_row0,chunk,ties", CASES)
def test_staged_version_matches_plain_and_jax(B, K, D, rows, valid_v, zero_row0, chunk, ties):
    u, items = _inputs(B + rows + chunk, B, K, D, rows, ties)
    lse = mm.multimax_lse_reference(u, items, valid_v, zero_row0)
    staged = _staged(u, items, lse, valid_v, zero_row0, chunk)
    plain = mm.multimax_grads_reference(u, items, lse, valid_v, zero_row0)
    _close(staged, plain)
    assert not staged[1][valid_v:].any()
    if zero_row0:
        assert not staged[1][0].any()
    if ties:
        assert not staged[0][:, 1:3].any() and bool(staged[0][:, 0].any())
    want_du, want_di = _jax_grads(u, items, lse, valid_v, zero_row0)
    row = 1 if zero_row0 else 0  # JAX gives the zero row 0 a gradient; the port none
    _close((staged[0], staged[1][row:]), (want_du, want_di[row:]))


def test_items_stage_from_the_pairs_alone():
    """d_items of a chunk from its p and k* (launch D's plain version) equals
    the d_items of the whole plain backward."""
    u, items = _inputs(7, 8, 4, 16, 512)
    lse = mm.multimax_lse_reference(u, items, 500, True)
    _, want = mm.multimax_grads_reference(u, items, lse, 500, True)
    p, ks, _ = mm.pairs_reference(u, items[256:], 256, lse, 500, True)
    torch.testing.assert_close(mm.items_reference(u, p, ks), want[256:], rtol=0, atol=0)
