"""The port's K-max softmax CE (K5's plain versions and the autograd
functions around them) against the JAX package's.

Inputs from a numpy seed.  The loss and both gradients (users [B, K, D],
items [V, D]) are held to the JAX ``fused_multimax_softmax_ce`` on its XLA
scan (over several chunks) and on its Pallas kernels in interpret mode
(``_fwd_kernel``, ``_bwd_kernel``), to the naive ``[B, K, V]`` form, at
highest matmul precision.  Tolerance: float32 on both sides, summed in other
orders: the loss within rtol 1e-5, each gradient within rtol 1e-5 and an
atol of 1e-5 times its largest entry.  A tie between interests routes the
whole gradient to the lowest one, as JAX's strict ``>`` does.  The CUDA
kernels run only on the card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.ops import softmax_ce as jsc
from rec_pangu_tpu_torch.convert import load_jax_variables
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.ops import softmax_ce as sc
from rec_pangu_tpu_torch.ops.kernels import multimax_ce as mm

B, K, D, V = 8, 4, 16, 1000


def _inputs(seed, ties=False):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, K, D)).astype(np.float32)
    if ties:  # interests 1 and 3 repeat 0 and 2: every item ties between them
        u[:, 1], u[:, 3] = u[:, 0], u[:, 2]
    items = rng.standard_normal((V, D)).astype(np.float32)
    pos = rng.integers(0, V, B)
    return u, items, pos


def _jax(fn, u, items, pos):
    with jax.default_matmul_precision("highest"):
        loss = fn(jnp.asarray(u), jnp.asarray(items), jnp.asarray(pos))
        grads = jax.grad(lambda a, b: fn(a, b, jnp.asarray(pos)), (0, 1))(
            jnp.asarray(u), jnp.asarray(items))
    return float(loss), [np.array(g) for g in grads]


def _port(fn, u, items, pos):
    ut = torch.from_numpy(u).requires_grad_()
    it = torch.from_numpy(items).requires_grad_()
    loss = fn(ut, it, torch.from_numpy(pos))
    loss.backward()
    return float(loss.detach()), [ut.grad.numpy(), it.grad.numpy()]


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, a, b in zip(("d_user", "d_items"), got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(), err_msg=name)


def _naive_jax(u, items, pos):
    logp = jax.nn.log_softmax(jnp.max(jnp.einsum("bkd,nd->bkn", u, items), axis=1), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, pos[:, None], axis=1))


@pytest.mark.parametrize("chunk", [64, None])
def test_matches_jax_scan(chunk, monkeypatch):
    if chunk:  # 16 chunks, the last one ragged, on both sides
        monkeypatch.setattr(jsc, "CHUNK_V", chunk)
        monkeypatch.setattr(mm, "CHUNK", chunk)
    monkeypatch.setenv("REC_PANGU_TPU_MULTIMAX_KERNEL", "0")
    u, items, pos = _inputs(1)
    _assert_close(_port(sc.fused_multimax_softmax_ce, u, items, pos),
                  _jax(jsc.fused_multimax_softmax_ce, u, items, pos))


def test_matches_jax_pallas_kernels_interpret(monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_MULTIMAX_KERNEL", "1")
    monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
    from rec_pangu_tpu.ops.kernels import multimax_ce as jmm

    calls = []
    grid_call = jmm._grid_call
    monkeypatch.setattr(jmm, "_grid_call", lambda *a, **k: calls.append(1) or grid_call(*a, **k))
    u, items, pos = _inputs(2)
    want = _jax(jsc.fused_multimax_softmax_ce, u, items, pos)
    assert len(calls) >= 2, "the JAX CE did not reach its Pallas kernels"
    _assert_close(_port(sc.fused_multimax_softmax_ce, u, items, pos), want)


def test_matches_naive_form():
    u, items, pos = _inputs(3)
    naive = _port(sc.naive_multimax_softmax_ce, u, items, pos)
    _assert_close(naive, _jax(_naive_jax, u, items, pos))
    _assert_close(_port(sc.fused_multimax_softmax_ce, u, items, pos), naive)


def test_ties_go_to_the_lowest_interest(monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_MULTIMAX_KERNEL", "0")
    u, items, pos = _inputs(4, ties=True)
    got = _port(sc.fused_multimax_softmax_ce, u, items, pos)
    _assert_close(got, _jax(jsc.fused_multimax_softmax_ce, u, items, pos))
    assert not got[1][0][:, 1].any() and not got[1][0][:, 3].any()
    lse = mm.multimax_lse_reference(torch.from_numpy(u), torch.from_numpy(items), V)
    du, _ = mm.multimax_grads_reference(torch.from_numpy(u), torch.from_numpy(items), lse, V)
    assert du[:, 0].abs().sum() > 0 and not du[:, 1].any()


def _padded_case(seed):
    u, _, pos = _inputs(seed)
    rng = np.random.default_rng(seed + 100)
    rows, valid = 1100, V  # 100 padding rows past the vocabulary
    table = rng.standard_normal((rows, D)).astype(np.float32)
    pos[0] = 0  # a target of 0 reads the zero row
    candidates = table[:valid] * (np.arange(valid) != 0)[:, None]  # output_items()
    return u, table, pos, candidates, valid


def test_padded_table_reads_row0_as_zero_and_masks_the_padding(monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_MULTIMAX_KERNEL", "0")
    u, table, pos, candidates, valid = _padded_case(5)
    loss, (d_user, d_table) = _port(
        lambda a, b, c: sc.fused_multimax_softmax_ce_padded(a, b, c, valid), u, table, pos)
    want_loss, (want_user, want_items) = _jax(jsc.fused_multimax_softmax_ce, u, candidates, pos)
    want_items[0] = 0.0  # all_items() stops the gradient to row 0
    _assert_close((loss, (d_user, d_table[:valid])), (want_loss, (want_user, want_items)))
    assert not d_table[valid:].any() and not d_table[0].any()


def test_captured_sink_holds_the_table_gradient(monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_MULTIMAX_KERNEL", "0")
    u, table, pos, candidates, valid = _padded_case(6)
    rows = table.shape[0]

    def jax_loss(a, cap_t):
        return jsc.fused_multimax_softmax_ce_captured(a, jnp.asarray(candidates),
                                                      jnp.asarray(pos), cap_t, rows)

    with jax.default_matmul_precision("highest"):
        cap = jnp.zeros((D, rows), jnp.float32)
        want_loss = float(jax_loss(jnp.asarray(u), cap))
        want_user, want_cap = jax.grad(jax_loss, (0, 1))(jnp.asarray(u), cap)
    sink = []
    ut = torch.from_numpy(u).requires_grad_()
    tt = torch.from_numpy(table)
    loss = sc.fused_multimax_softmax_ce_captured(ut, tt, torch.from_numpy(pos), sink, valid)
    loss.backward()
    (dense,) = sink
    assert dense.shape == (rows, D) and tt.grad is None
    _assert_close((float(loss.detach()), (ut.grad.numpy(), dense.numpy())),
                  (want_loss, (np.asarray(want_user), np.asarray(want_cap).T)))
    assert not dense[0].any() and not dense[valid:].any()


def test_sampled_loss_matches_jax_for_the_same_negatives():
    enc = {"item_id": {"vocab_size": 200}}
    config = {"embedding_dim": D, "max_length": 6, "K": K}
    rng = np.random.default_rng(7)
    batch = {"hist_item_list": rng.integers(1, 200, (B, 6)).astype(np.int32),
             "hist_mask_list": np.ones((B, 6), np.float32),
             "target_item": rng.integers(1, 200, B).astype(np.int32)}
    jmodel = jax_get_model("IOCRec")(enc_dict=enc, config=config)
    rngs = {"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}
    params = jax.jit(lambda r, b: jmodel.init(r, b, False))(rngs, batch)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    u = rng.standard_normal((B, K, D)).astype(np.float32)
    n = 50
    # without a dropout key the JAX model draws its negatives from PRNGKey(0)
    want = jmodel.apply({"params": params}, jnp.asarray(u), jnp.asarray(batch["target_item"]),
                        n, method="calculate_multimax_sampled_loss")
    neg = np.array(jax.random.randint(jax.random.PRNGKey(0), (n,), 1, 200))
    model = get_model("IOCRec")(enc_dict=enc, config=config)
    load_jax_variables(model, {"params": params})
    got = model.calculate_multimax_sampled_loss(torch.from_numpy(u),
                                                torch.from_numpy(batch["target_item"]), n,
                                                neg_ids=torch.from_numpy(neg))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    drawn = model.calculate_multimax_sampled_loss(torch.from_numpy(u),
                                                  torch.from_numpy(batch["target_item"]), n,
                                                  torch.Generator().manual_seed(0))
    assert np.isfinite(float(drawn.detach()))


def test_rejects_bad_inputs():
    u, items = (torch.from_numpy(a) for a in _inputs(8)[:2])
    with pytest.raises(ValueError, match="K <= 4"):
        mm.check_supported(5, D)
    with pytest.raises(ValueError, match="valid_v"):
        mm.multimax_lse(u, items, 0)
    with pytest.raises(ValueError, match=r"\[B, K, D\]"):
        mm.multimax_lse(u[:, 0], items, V)
    with pytest.raises(ValueError, match="user_embs"):
        sc.fused_multimax_softmax_ce(u, items[:, :3], torch.zeros(B, dtype=torch.long))


def test_cpu_builds_and_launches_nothing(monkeypatch):
    from rec_pangu_tpu_torch.ops.kernels import _build

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU call built a kernel")

    monkeypatch.setattr(_build, "build_all", no_build)
    u, items, pos = _inputs(9)
    _port(sc.fused_multimax_softmax_ce, u, items, pos)
    assert mm.LAUNCHES == mm.BACKWARD_LAUNCHES == 0 and mm._LSE_FN is None
    assert {"global_attn", "multimax_ce"} <= set(_build.SOURCES)
