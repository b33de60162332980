"""K7's counterpart, ``embedding_grad.sorted_segment_accumulate``, against the
JAX package's ``sorted_segment_accumulate``: the dense table gradient from
ids sorted on the device (its Pallas ``_accumulate_kernel`` run in interpret
mode at ``highest`` precision, so its one-hot products add the f32 rows
exactly).

On the CPU the port's function is its plain version (``index_add_`` in
batch order); the JAX kernel sums each tile's sorted rows by one-hot
products, whose reduction order is the matmul's.  Held within 1e-6 of each
array's largest entry: cases with several vocab tiles, an odd N, every id
equal, and ids outside ``[0, num_rows)``, which add nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.ops.kernels import embedding_grad as jgrad
from rec_pangu_tpu_torch.ops.kernels import embedding_grad as grad

REL_TOL = 1e-6


def _ids(kind, rng, n, num_rows):
    if kind == "all_equal":
        return np.full(n, num_rows // 3, np.int64)
    if kind == "out_of_range":  # past both ends, duplicates inside
        return rng.integers(-50, num_rows + 3000, n)
    return rng.integers(0, num_rows, n)


CASES = [  # (num_rows, D, N, ids)
    (1024, 8, 300, "uniform"),
    (4096, 64, 1001, "uniform"),          # several tiles, odd N
    (8192, 32, 5000, "uniform"),
    (3001, 16, 777, "out_of_range"),      # rows not a tile multiple
    (2048, 16, 999, "all_equal"),
]


@pytest.fixture
def jax_accumulate(monkeypatch):
    """A fresh jit of the JAX function, traced with the kernel in interpret
    mode at ``highest`` precision (both flags are read at trace time)."""
    monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("REC_PANGU_TPU_EMB_GRAD_PRECISION", "highest")
    calls = []
    pallas_call = jgrad.pl.pallas_call

    def counting(*args, **kwargs):
        calls.append(1)
        return pallas_call(*args, **kwargs)

    monkeypatch.setattr(jgrad.pl, "pallas_call", counting)
    fn = jax.jit(jgrad.sorted_segment_accumulate.__wrapped__, static_argnums=(2,))
    return fn, calls


@pytest.mark.parametrize("num_rows,dim,n,kind", CASES)
def test_matches_jax_sorted_segment_accumulate(num_rows, dim, n, kind, jax_accumulate):
    fn, calls = jax_accumulate
    rng = np.random.default_rng(num_rows + n)
    ids = _ids(kind, rng, n, num_rows)
    rows = rng.standard_normal((n, dim)).astype(np.float32)
    want = np.asarray(fn(jnp.asarray(ids, jnp.int32), jnp.asarray(rows), num_rows))
    assert calls, "the JAX function did not reach its Pallas kernel"
    got = grad.sorted_segment_accumulate(torch.from_numpy(ids), torch.from_numpy(rows),
                                         num_rows).numpy()
    assert got.shape == want.shape == (num_rows, dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * np.abs(want).max())
    hit = np.unique(ids[(ids >= 0) & (ids < num_rows)])
    untouched = np.setdiff1d(np.arange(num_rows), hit)
    assert not got[untouched].any()


def test_is_the_table_gradient_of_int32_ids():
    """The JAX name over ``table_grad``: any integer ids, cast to int32;
    the same checks and the same bits."""
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 40, 500)
    rows = torch.from_numpy(rng.standard_normal((500, 5)).astype(np.float32))
    got = grad.sorted_segment_accumulate(torch.from_numpy(ids), rows, 40)
    want = grad.table_grad(torch.from_numpy(ids.astype(np.int32)), rows, 40)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="rows must be"):
        grad.sorted_segment_accumulate(torch.from_numpy(ids), rows[:10], 40)
    assert grad.LAUNCHES == 0  # the CPU launches nothing
