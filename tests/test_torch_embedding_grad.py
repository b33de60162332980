"""The port's table gradient (K2's counterpart) against the JAX package's K2.

JAX runs its Pallas planned backward (``_chunk_kernel`` behind
``presorted_segment_accumulate``) in interpret mode at ``highest`` precision.
Its one-hot matmuls sum each row's terms in another order than the port's
plain version (``index_add_``, batch order), so the two agree to atol 1e-6
plus rtol 2e-6: f32 sums of a few unit-normal terms differ by a few ulps of
values below 10, and the one row summed from 40 terms by up to ten ulps of
its sum.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.ops.kernels import embedding_grad as jgrad
from rec_pangu_tpu_torch.data.encoder import FeatureSpec
from rec_pangu_tpu_torch.ops import embedding as temb
from rec_pangu_tpu_torch.ops.kernels import _build
from rec_pangu_tpu_torch.ops.kernels import embedding_grad as grad
from rec_pangu_tpu_torch.ops.kernels import embedding_lookup as lookup

FIELDS, VOCAB, BATCH = 4, 16384, 2048  # 4 x 16,385 rows -> padded 73,728
ATOL, RTOL = 1e-6, 2e-6


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("REC_PANGU_TPU_EMB_GRAD_PRECISION", "highest")


def _spec():
    return FeatureSpec(tuple(f"s{i}" for i in range(FIELDS)), (), (VOCAB + 1,) * FIELDS)


def _batch(seed, dim):
    rng = np.random.default_rng(seed)
    sparse = rng.integers(0, VOCAB + 1, (BATCH, FIELDS)).astype(np.int32)
    sparse[:300] = sparse[300:600]          # duplicates: rows hit twice or more
    sparse[600:640, 1] = 7                  # one row hit 40 times
    rows = rng.standard_normal((BATCH * FIELDS, dim)).astype(np.float32)
    return sparse, rows


@pytest.mark.parametrize("dim", [8, 32])
def test_plain_version_matches_jax_k2(dim, monkeypatch):
    spec = _spec()
    num_rows = temb.padded_rows(spec.total_rows)
    sparse, rows = _batch(dim, dim)
    fused = temb.host_fused_ids(spec, sparse)
    plan = {k: jnp.asarray(v) for k, v in jgrad.make_sort_plan(fused, num_rows, dim=dim).items()}
    stream = jgrad.stream_ids(plan, jnp.asarray(fused, jnp.int32), num_rows)
    calls = []
    accumulate = jgrad.pl.pallas_call

    def counting(*args, **kwargs):
        calls.append(1)
        return accumulate(*args, **kwargs)

    monkeypatch.setattr(jgrad.pl, "pallas_call", counting)
    expected = np.asarray(jgrad.presorted_segment_accumulate(
        plan, jnp.asarray(rows), num_rows, stream))
    assert calls, "the JAX backward did not reach its Pallas kernel"
    got = grad.table_grad(torch.from_numpy(fused.astype(np.int32)), torch.from_numpy(rows),
                          num_rows)
    assert got.shape == expected.shape == (num_rows, dim)
    np.testing.assert_allclose(got.numpy(), expected, rtol=RTOL, atol=ATOL)
    untouched = np.setdiff1d(np.arange(num_rows), fused)
    assert not got.numpy()[untouched].any()


def test_plain_version_sums_in_batch_order():
    """On the CPU each row's terms are added one after another in batch
    order, so a sequential loop gives the same bits; the kernel adds them in
    that order within each 32-entry chunk of its stable sort, and the
    sort's permutation is the stable argsort."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 50, 4000).astype(np.int32)
    rows = rng.standard_normal((4000, 3)).astype(np.float32)
    want = np.zeros((50, 3), np.float32)
    for i, r in zip(ids, rows):
        want[i] += r
    got = grad.table_grad(torch.from_numpy(ids), torch.from_numpy(rows), 50)
    np.testing.assert_array_equal(got.numpy(), want)
    sorted_ids, perm = grad.sort_ids(torch.from_numpy(ids))
    assert sorted_ids.dtype == perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.argsort(ids, kind="stable"))


def test_lookup_autograd_gradient_is_the_plain_table_gradient():
    spec = FeatureSpec(("a", "b", "c"), (), (5, 6, 4))
    offsets = torch.from_numpy(spec.offsets.copy())
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((15, 4)).astype(np.float32)).requires_grad_()
    sparse = torch.from_numpy(rng.integers(0, 4, (64, 3)).astype(np.int32))
    sparse[0, 2] = 9      # fused id 20: out of range, a zero row and no gradient
    sparse[1, 0] = -3     # fused id -3: likewise
    cot = torch.from_numpy(rng.standard_normal((64, 3, 4)).astype(np.float32))
    (lookup.fused_embedding_lookup(table, sparse, offsets) * cot).sum().backward()
    ids = lookup.fused_ids(sparse, offsets)
    want = grad.table_grad(ids, cot.reshape(-1, 4), 15)
    np.testing.assert_array_equal(table.grad.numpy(), want.numpy())
    np.testing.assert_array_equal(want.numpy()[[4, 9, 10]], 0.0)  # no id falls there


def test_inputs_are_checked():
    ids = torch.zeros(4, dtype=torch.int32)
    rows = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="int32"):
        grad.table_grad(ids.long(), rows, 3)
    with pytest.raises(ValueError, match="rows must be"):
        grad.table_grad(ids, torch.zeros(5, 2), 3)
    with pytest.raises(ValueError, match="at least one row"):
        grad.table_grad(ids, rows, 0)
    assert grad.table_grad(ids[:0], rows[:0], 3).abs().sum() == 0  # an empty batch


def test_cpu_gradient_builds_and_launches_nothing(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU gradient must not build a kernel")

    monkeypatch.setattr(_build, "build_all", no_build)
    assert grad.LAUNCHES == 0 and grad._FN is None
    out = grad.table_grad(torch.tensor([1, 1], dtype=torch.int32), torch.ones(2, 2), 3)
    np.testing.assert_array_equal(out.numpy(), [[0, 0], [2, 2], [0, 0]])
    assert grad.LAUNCHES == 0 and grad._FN is None
    assert {"embedding_grad", "fused_adam"} <= set(_build.SOURCES)
