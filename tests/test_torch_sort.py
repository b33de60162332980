"""The sort behind the table kernels (``embedding_grad.sort_ids``) and the
plain paths of K2, K7 and K3 on ids outside the table.

On the CPU ``sort_ids`` is its plain version: a stable ``torch.sort`` of the
ids clamped to ``[-1, num_rows]``, which must equal numpy's stable argsort of
the same keys exactly.  ``sort_plan`` cuts the keys' bits into the radix
sort's passes; it is checked at every table size where the bit count
changes.  The plain K2, K3 and K7 paths are held against the JAX package's
kernels (interpret mode, ``highest`` precision) with ids past both ends of
the table, which add nothing: JAX's K2 and K3 plans refuse such ids, so
they get the in-range ids alone, and JAX's K7 takes them as they are.
Tolerances as in the K2/K3/K7 tests: atol 1e-6 plus rtol 2e-6 for the
gradient (f32 sums in another order), K3's p within 1e-6 and m, v within
rtol 1e-5 after two steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.ops.kernels import embedding_grad as jgrad
from rec_pangu_tpu.ops.kernels import fused_adam as jadam
from rec_pangu_tpu_torch.ops.kernels import _build
from rec_pangu_tpu_torch.ops.kernels import embedding_grad as grad
from rec_pangu_tpu_torch.ops.kernels import fused_adam as adam

ROWS, DIM, N = 4096, 8, 3000
LR = 1e-3


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("REC_PANGU_TPU_EMB_GRAD_PRECISION", "highest")


def _ids(kind: str, num_rows: int, rng) -> np.ndarray:
    if kind == "empty":
        return np.zeros(0, np.int32)
    if kind == "twenty":
        return rng.integers(0, num_rows, 20).astype(np.int32)
    if kind == "all_equal":
        return np.full(5000, num_rows // 2, np.int32)
    if kind == "out_of_range":  # past both ends, some far past, duplicates inside
        ids = rng.integers(-40, num_rows + 40, 5000)
        ids[:10] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, -2, -1, num_rows,
                    num_rows + 1, 0, num_rows - 1, -(2 ** 30), 2 ** 30]
        return ids.astype(np.int32)
    ids = rng.integers(0, num_rows, 5000)
    ids[:1000] = ids[1000:2000]  # duplicates
    return ids.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "out_of_range", "empty", "twenty", "all_equal"])
def test_plain_sort_is_the_stable_argsort_of_the_clamped_ids(kind):
    num_rows = 3001
    ids = _ids(kind, num_rows, np.random.default_rng(len(kind)))
    keys = np.clip(ids, -1, num_rows)
    sorted_ids, perm = grad.sort_ids(torch.from_numpy(ids), num_rows)
    assert sorted_ids.dtype == perm.dtype == torch.int32
    want = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(sorted_ids.numpy(), keys[want])


def test_clamping_keeps_every_in_range_position():
    """In-range ids sit where a stable sort of the raw ids puts them: the
    clamp only merges the ids below 0 and those at or past the end, which
    sort before and after them either way."""
    rng = np.random.default_rng(7)
    num_rows = 1000
    ids = _ids("out_of_range", num_rows, rng)
    raw = np.argsort(ids, kind="stable")
    sorted_ids, perm = grad.sort_ids(torch.from_numpy(ids), num_rows)
    inside = (ids[raw] >= 0) & (ids[raw] < num_rows)
    assert inside.sum() > 4000
    np.testing.assert_array_equal(perm.numpy()[inside], raw[inside])
    np.testing.assert_array_equal(sorted_ids.numpy()[inside], ids[raw][inside])


@pytest.mark.parametrize("num_rows,plan", [
    (1, (2, 2, 1)),               # keys 0..2
    (2, (2, 2, 1)),               # keys 0..3
    (254, (8, 8, 1)),             # 2^8 - 2: the last table of one 8-bit pass
    (255, (9, 5, 2)),             # 2^8 - 1: one more key bit, two passes
    (256, (9, 5, 2)),
    (2 ** 16 - 2, (16, 8, 2)),
    (2 ** 16 - 1, (17, 6, 3)),
    (2 ** 16, (17, 6, 3)),
    (1_007_616, (20, 7, 3)),      # K7's table (ContraRec's padded items)
    (1_605_632, (21, 7, 3)),      # the DeepFM bench table
    (2 ** 24 - 2, (24, 8, 3)),
    (2 ** 24 - 1, (25, 7, 4)),
    (2 ** 31 - 1, (32, 8, 4)),    # keys up to 2^31: all 32 bits
])
def test_sort_plan_covers_the_key_bits(num_rows, plan):
    key_bits, digit_bits, passes = grad.sort_plan(num_rows)
    assert (key_bits, digit_bits, passes) == plan
    assert 2 ** (key_bits - 1) <= num_rows + 1 < 2 ** key_bits  # the largest key fits
    assert digit_bits * passes >= key_bits and digit_bits * (passes - 1) < key_bits
    assert digit_bits <= grad.MAX_DIGIT_BITS


def test_sort_plan_and_sort_refuse_what_the_kernel_cannot_take(monkeypatch):
    for num_rows in (0, -3, 2 ** 31):
        with pytest.raises(ValueError, match="rows"):
            grad.sort_plan(num_rows)
    with pytest.raises(ValueError, match="int32"):
        grad.sort_ids(torch.zeros(3, dtype=torch.int64), 10)
    with pytest.raises(ValueError, match="1-D"):
        grad.sort_ids(torch.zeros(2, 3, dtype=torch.int32), 10)

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU sort must not build a kernel")

    monkeypatch.setattr(_build, "build_all", no_build)
    grad.sort_ids(torch.tensor([3, -1, 3], dtype=torch.int32), 10)
    assert grad.SORT_LAUNCHES == 0 and grad._FN is None


def _rows(rng, n, dim=DIM):
    return rng.standard_normal((n, dim)).astype(np.float32)


def _jax_k2(ids: np.ndarray, rows: np.ndarray, num_rows: int, dim: int) -> np.ndarray:
    """JAX's planned K2 over the in-range ids (its plan refuses the others)."""
    keep = (ids >= 0) & (ids < num_rows)
    plan = {k: jnp.asarray(v) for k, v in
            jgrad.make_sort_plan(ids[keep], num_rows, dim=dim).items()}
    stream = jgrad.stream_ids(plan, jnp.asarray(ids[keep]), num_rows)
    return np.asarray(jgrad.presorted_segment_accumulate(plan, jnp.asarray(rows[keep]),
                                                         num_rows, stream))


@pytest.mark.parametrize("dim", [8, 32])
def test_plain_k2_matches_jax_k2_with_ids_outside_the_table(dim):
    rng = np.random.default_rng(dim)
    ids = _ids("out_of_range", ROWS, rng)
    rows = _rows(rng, ids.size, dim)
    want = _jax_k2(ids, rows, ROWS, dim)
    got = grad.table_grad(torch.from_numpy(ids), torch.from_numpy(rows), ROWS).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    hit = np.unique(ids[(ids >= 0) & (ids < ROWS)])
    assert not got[np.setdiff1d(np.arange(ROWS), hit)].any()


def test_plain_k7_matches_jax_k7_with_ids_far_outside_the_table():
    rng = np.random.default_rng(11)
    ids = _ids("out_of_range", ROWS, rng)
    rows = _rows(rng, ids.size)
    fn = jax.jit(jgrad.sorted_segment_accumulate.__wrapped__, static_argnums=(2,))
    want = np.asarray(fn(jnp.asarray(ids), jnp.asarray(rows), ROWS))
    got = grad.sorted_segment_accumulate(torch.from_numpy(ids), torch.from_numpy(rows),
                                         ROWS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(got, _jax_k2(ids, rows, ROWS, DIM), rtol=2e-6, atol=1e-6)


def test_plain_k3_matches_jax_k3_with_ids_outside_the_table():
    rng = np.random.default_rng(13)
    p0 = (rng.standard_normal((ROWS, DIM)) * 0.01).astype(np.float32)
    jp, jm, jv = jnp.asarray(p0), jnp.zeros((ROWS, DIM)), jnp.zeros((ROWS, DIM))
    tp, tm, tv = torch.from_numpy(p0.copy()), torch.zeros(ROWS, DIM), torch.zeros(ROWS, DIM)
    for t in (1, 2):
        ids = _ids("out_of_range", ROWS, rng)
        rows = _rows(rng, ids.size)
        keep = (ids >= 0) & (ids < ROWS)
        plan = {k: jnp.asarray(v) for k, v in
                jgrad.make_sort_plan(ids[keep], ROWS, dim=DIM).items()}
        stream = jgrad.stream_ids(plan, jnp.asarray(ids[keep]), ROWS)
        jp, jm, jv = jadam.planned_adam_update(
            plan, stream, jnp.asarray(rows[keep]), jp, jm, jv,
            jadam.adam_hyper(jnp.asarray(t, jnp.int32), LR))
        adam.planned_adam_update(torch.from_numpy(ids), torch.from_numpy(rows), tp, tm, tv,
                                 adam.adam_hyper(t, LR))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
