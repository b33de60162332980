"""The port's fused table Adam (K3's counterpart) against the JAX package's K3.

JAX runs ``planned_adam_update`` (``_adam_tile_kernel``) in interpret mode at
``highest`` precision.  The gradient sums differ from the port's by rounding
(one-hot matmuls against batch-order adds), and that difference passes
through the Adam arithmetic: p within atol 1e-6, m and v within atol 1e-6 /
rtol 1e-5 after three steps.  With K3's dense stream (``dense_grad_t`` in
JAX, ``dense`` here) the same.  With bfloat16 moments both sides round m and
v to bfloat16 after f32 arithmetic; a gradient sum that differs in its last
bit can move a moment to the neighbouring bfloat16 (2^-8 relative), which
moves that step's update, lr * m_hat / sqrt(v_hat), by up to about lr *
2^-8: m and v within rtol 2^-7, p within atol lr * 2^-7 (seen: 2.1e-6).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.ops.kernels import embedding_grad as jgrad
from rec_pangu_tpu.ops.kernels import fused_adam as jadam
from rec_pangu_tpu_torch.ops.kernels import _build
from rec_pangu_tpu_torch.ops.kernels import fused_adam as adam

ROWS, DIM, N = 73_728, 32, 8192  # a padded 4 x 16,385-row table, 2048 x 4 ids
LR = 1e-3


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("REC_PANGU_TPU_EMB_GRAD_PRECISION", "highest")


@pytest.mark.parametrize("step", [1, 2, 3, 10, 1000, 123_457])
def test_adam_hyper_equals_jax_in_f32(step):
    for lr in (1e-3, 0.37):
        want = np.asarray(jadam.adam_hyper(jnp.asarray(step, jnp.int32), lr))
        got = adam.adam_hyper(step, lr)
        assert got.dtype == torch.float32 and got.shape == (8,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_three_steps_match_jax_k3_and_absent_rows_decay():
    rng = np.random.default_rng(0)
    p0 = (rng.standard_normal((ROWS, DIM)) * 0.01).astype(np.float32)
    jp, jm, jv = jnp.asarray(p0), jnp.zeros((ROWS, DIM)), jnp.zeros((ROWS, DIM))
    tp, tm, tv = torch.from_numpy(p0.copy()), torch.zeros(ROWS, DIM), torch.zeros(ROWS, DIM)
    batches = []
    for t in (1, 2, 3):
        ids = rng.integers(0, ROWS, N)
        ids[:500] = ids[500:1000]  # duplicates
        rows = rng.standard_normal((N, DIM)).astype(np.float32)
        batches.append((ids, rows))
        plan = {k: jnp.asarray(v) for k, v in jgrad.make_sort_plan(ids, ROWS, dim=DIM).items()}
        stream = jgrad.stream_ids(plan, jnp.asarray(ids, jnp.int32), ROWS)
        jp, jm, jv = jadam.planned_adam_update(
            plan, stream, jnp.asarray(rows), jp, jm, jv,
            jadam.adam_hyper(jnp.asarray(t, jnp.int32), LR))
        m_before = tm.clone()
        adam.planned_adam_update(torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(rows),
                                 tp, tm, tv, adam.adam_hyper(t, LR))
        if t == 2:  # rows of step 1 that step 2 does not touch: moments decay
            absent = np.setdiff1d(batches[0][0], ids)
            np.testing.assert_array_equal(tm.numpy()[absent],
                                          (np.float32(0.9) * m_before.numpy()[absent]))
            assert np.all(tp.numpy()[absent] != p_after_1[absent])  # still nudged
        p_after_1 = tp.numpy().copy()
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    never = np.setdiff1d(np.arange(ROWS), np.concatenate([b[0] for b in batches]))
    np.testing.assert_array_equal(tm.numpy()[never], 0.0)
    np.testing.assert_array_equal(tp.numpy()[never], p0[never])


def test_matches_dense_torch_adam_on_one_step():
    """Adam over the dense gradient: one step equals torch.optim.Adam on the
    table with the plain gradient.  torch rounds its update in another order,
    which can move the result by one ulp of p (atol 1e-6 for |p| < 4)."""
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 300, 1000).astype(np.int32))
    rows = torch.from_numpy(rng.standard_normal((1000, 4)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((300, 4)).astype(np.float32))
    ref = table.clone().requires_grad_()
    opt = torch.optim.Adam([ref], lr=LR, betas=(0.9, 0.999), eps=1e-8)
    ref.grad = torch.zeros(300, 4).index_add_(0, ids.long(), rows)
    opt.step()
    m, v = torch.zeros(300, 4), torch.zeros(300, 4)
    adam.planned_adam_update(ids, rows, table, m, v, adam.adam_hyper(1, LR))
    np.testing.assert_allclose(table.numpy(), ref.detach().numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(m.numpy(), opt.state[ref]["exp_avg"].numpy(), rtol=1e-6)


def test_empty_batch_still_decays_every_row():
    table, m, v = torch.ones(5, 2), torch.full((5, 2), 0.5), torch.full((5, 2), 0.25)
    adam.planned_adam_update(torch.zeros(0, dtype=torch.int32), torch.zeros(0, 2), table, m, v,
                             adam.adam_hyper(2, LR))
    np.testing.assert_array_equal(m.numpy(), np.float32(0.9) * np.float32(0.5))
    assert np.all(table.numpy() < 1.0)


def test_inputs_are_checked_and_cpu_builds_nothing(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU update must not build a kernel")

    monkeypatch.setattr(_build, "build_all", no_build)
    ids, rows = torch.zeros(3, dtype=torch.int32), torch.ones(3, 2)
    t, m, v = torch.zeros(4, 2), torch.zeros(4, 2), torch.zeros(4, 2)
    with pytest.raises(ValueError, match="mu must be"):
        adam.planned_adam_update(ids, rows, t, torch.zeros(4, 3), v, adam.adam_hyper(1, LR))
    with pytest.raises(ValueError, match="hyper"):
        adam.planned_adam_update(ids, rows, t, m, v, torch.zeros(6))
    adam.planned_adam_update(ids, rows, t, m, v, adam.adam_hyper(1, LR))
    assert adam.LAUNCHES == 0 and adam._FN is None
    assert adam.tile_plan(1_605_632, 32, 132).tile_rows == 64
    assert adam.tile_plan(1_605_632, 1, 132).tile_rows == 2048
    with pytest.raises(ValueError, match="at most"):
        adam.planned_adam_update(ids, torch.ones(3, 8193), torch.zeros(4, 8193),
                                 torch.zeros(4, 8193), torch.zeros(4, 8193),
                                 adam.adam_hyper(1, LR))
    np.testing.assert_allclose(t.numpy()[0], -LR, rtol=1e-6)  # the first step is lr*sign(g)


def _dense_case(seed):
    rng = np.random.default_rng(seed)
    p0 = (rng.standard_normal((ROWS, DIM)) * 0.01).astype(np.float32)
    ids = rng.integers(0, ROWS, N)
    ids[:300] = ids[300:600]  # duplicates
    rows = rng.standard_normal((N, DIM)).astype(np.float32)
    dense = (rng.standard_normal((ROWS, DIM)) * 0.1).astype(np.float32)
    dense[rng.random(ROWS) < 0.5] = 0.0  # rows the dense gradient does not reach
    return p0, ids, rows, dense


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_dense_stream_and_moment_dtype_match_jax_k3(moments, monkeypatch):
    from rec_pangu_tpu.train.fused_update import _moment_dtype as jax_moment_dtype
    from rec_pangu_tpu_torch.train.fused_update import _moment_dtype

    monkeypatch.setenv("REC_PANGU_TPU_MOMENT_DTYPE", moments)
    jdt, tdt = jax_moment_dtype(), _moment_dtype()
    assert (str(jnp.dtype(jdt)), tdt) in (("float32", torch.float32),
                                         ("bfloat16", torch.bfloat16))
    p0, _, _, _ = _dense_case(5)
    jp, jm, jv = jnp.asarray(p0), jnp.zeros((ROWS, DIM), jdt), jnp.zeros((ROWS, DIM), jdt)
    tp = torch.from_numpy(p0.copy())
    tm, tv = torch.zeros(ROWS, DIM, dtype=tdt), torch.zeros(ROWS, DIM, dtype=tdt)
    for t in (1, 2, 3):
        _, ids, rows, dense = _dense_case(10 + t)
        plan = {k: jnp.asarray(v) for k, v in jgrad.make_sort_plan(ids, ROWS, dim=DIM).items()}
        stream = jgrad.stream_ids(plan, jnp.asarray(ids, jnp.int32), ROWS)
        jp, jm, jv = jadam.planned_adam_update(
            plan, stream, jnp.asarray(rows), jp, jm, jv,
            jadam.adam_hyper(jnp.asarray(t, jnp.int32), LR),
            dense_grad_t=jnp.asarray(dense.T))
        adam.planned_adam_update(torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(rows),
                                 tp, tm, tv, adam.adam_hyper(t, LR), torch.from_numpy(dense))
    assert tm.dtype == tdt and str(jm.dtype) == str(jnp.dtype(jdt))
    rtol = 2.0 ** -7 if moments == "bf16" else 1e-5
    p_atol = LR * 2.0 ** -7 if moments == "bf16" else 1e-6
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=p_atol)
    np.testing.assert_allclose(tm.float().numpy(), np.asarray(jm, np.float32), rtol=rtol,
                               atol=1e-6)
    np.testing.assert_allclose(tv.float().numpy(), np.asarray(jv, np.float32), rtol=rtol,
                               atol=1e-6)


def test_dense_stream_adds_to_the_summed_rows():
    """One step with ids and a dense gradient equals one step whose rows
    carry the same total gradient, bit for bit (the sum g = rows + dense is
    one rounding either way when each row is hit once)."""
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.permutation(300)[:100].astype(np.int32))
    rows = torch.from_numpy(rng.standard_normal((100, 4)).astype(np.float32))
    dense = torch.from_numpy(rng.standard_normal((300, 4)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((300, 4)).astype(np.float32))
    a = [table.clone(), torch.zeros(300, 4), torch.zeros(300, 4)]
    adam.planned_adam_update(ids, rows, *a, adam.adam_hyper(1, LR), dense)
    total = dense.clone().index_add_(0, ids.long(), rows)
    b = [table.clone(), torch.zeros(300, 4), torch.zeros(300, 4)]
    adam.planned_adam_update(torch.zeros(0, dtype=torch.int32), torch.zeros(0, 4), *b,
                             adam.adam_hyper(1, LR), total)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="dense must be"):
        adam.planned_adam_update(ids, rows, *a, adam.adam_hyper(2, LR), dense[:5])
    with pytest.raises(ValueError, match="share a dtype"):
        adam.planned_adam_update(ids, rows, a[0], a[1], a[2].bfloat16(), adam.adam_hyper(2, LR))


H100_SMS = 132
# the tables K3 runs on: DeepFM's and the LR tables' bench table, SASRec's
# padded corpus, chip_smoke's edge table
PLAN_ROWS = (1_605_632, 1_007_616, 3001)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [1, 8, 32, 40, 64, 128])
def test_tile_plan_fills_the_card_in_whole_lines(dim, moments, dense):
    """Every SM gets several tiles, a block's shared memory stays within what
    it takes without opting in, and every tile's slice of p, m, v (and the
    dense gradient) is whole 128-byte lines of float32 (64-byte ones of
    bfloat16), so it starts on its vector's boundary: 16 bytes for four
    f32, 8 for four bfloat16."""
    arrays = [torch.float32, moments, moments] + ([torch.float32] if dense else [])
    for num_rows in PLAN_ROWS:
        plan = adam.tile_plan(num_rows, dim, H100_SMS)
        assert (plan.grid - 1) * plan.tile_rows < num_rows <= plan.grid * plan.tile_rows
        assert plan.shared_bytes == plan.tile_rows * (dim + 1) * 4 <= adam.SHARED_LIMIT
        assert plan.tile_rows * dim <= adam.TILE_FLOATS
        assert plan.width == 4 and plan.tile_rows * dim % adam.TILE_ALIGN == 0
        for dtype in arrays:
            size = torch.tensor([], dtype=dtype).element_size()
            line, vector = adam.TILE_ALIGN * size, plan.width * size
            for b in (1, plan.grid // 2, plan.grid - 1):
                offset = b * plan.tile_rows * dim * size  # bytes from the array's start
                assert offset % line == 0 and offset % vector == 0
        step = adam.TILE_ALIGN // math.gcd(dim, adam.TILE_ALIGN)
        if num_rows > 3001:
            assert plan.grid >= adam.TILES_PER_SM * H100_SMS
        else:  # a small table: tiles of a line's rows, as many as make lines
            assert plan.grid >= min(H100_SMS, num_rows // step)


def test_tile_plan_of_wide_rows_and_refusals():
    """Where whole lines of rows do not fit a tile, a row is a tile of its
    own: float4s when D is a multiple of 4, single floats otherwise; D up to
    MAX_DIM."""
    assert adam.tile_plan(100, 4096, H100_SMS) == (1, 100, 4097 * 4, 4)
    assert adam.tile_plan(10 ** 6, 4096, H100_SMS) == (1, 10 ** 6, 4097 * 4, 4)
    assert adam.tile_plan(10 ** 6, 1024, H100_SMS) == (2, 500_000, 2 * 1025 * 4, 4)
    assert adam.tile_plan(100, 2049, H100_SMS) == (1, 100, 2050 * 4, 1)
    assert adam.tile_plan(100, 8191, H100_SMS).width == 1
    assert adam.tile_plan(7, adam.MAX_DIM, H100_SMS).shared_bytes <= adam.SHARED_LIMIT
    assert adam.tile_plan(1, 3, H100_SMS) == (32, 1, 32 * 4 * 4, 4)
    for args in ((0, 8, 132), (10, 0, 132), (10, adam.MAX_DIM + 1, 132), (10, 8, 0)):
        with pytest.raises(ValueError, match="no tile plan"):
            adam.tile_plan(*args)


def test_one_sort_updates_several_tables_as_separate_calls():
    """WDL's two tables on one ``sort_for``: the same bits as one
    ``planned_adam_update`` a table."""
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(-1, 301, 2000).astype(np.int32))
    plan = adam.sort_for(ids, 300)
    assert plan.sorted_ids is None and plan.num_rows == 300  # the CPU sorts nothing
    for dim in (1, 8):
        rows = torch.from_numpy(rng.standard_normal((2000, dim)).astype(np.float32))
        table = torch.from_numpy(rng.standard_normal((300, dim)).astype(np.float32))
        a = [table.clone(), torch.zeros(300, dim), torch.zeros(300, dim)]
        b = [table.clone(), torch.zeros(300, dim), torch.zeros(300, dim)]
        for t in (1, 2):
            adam.update_sorted(plan, rows, *a, adam.adam_hyper(t, LR))
            adam.planned_adam_update(ids, rows, *b, adam.adam_hyper(t, LR))
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_launch_refuses_a_sort_for_another_height():
    from rec_pangu_tpu_torch.ops.kernels.embedding_grad import sort_ids_reference

    ids = torch.tensor([0, 5, 99, 5], dtype=torch.int32)
    rows = torch.ones(4, 2)
    t, m, v = torch.zeros(50, 2), torch.zeros(50, 2), torch.zeros(50, 2)
    sorted100 = adam.SortedIds(ids, *sort_ids_reference(ids, 100), 100)
    with pytest.raises(ValueError, match="ready for a table of 100 rows, this one has 50"):
        adam.launch(sorted100, rows, t, m, v, adam.adam_hyper(1, LR))
    with pytest.raises(ValueError, match="ready for a table of 100 rows"):
        adam.update_sorted(adam.sort_for(ids, 100), rows, t, m, v, adam.adam_hyper(1, LR))
    with pytest.raises(ValueError, match="sorted on the card"):
        adam.launch(adam.sort_for(ids, 50), rows, t, m, v, adam.adam_hyper(1, LR))
    assert adam.LAUNCHES == 0 and torch.equal(t, torch.zeros(50, 2))
