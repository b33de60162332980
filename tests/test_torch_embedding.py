"""The port's embedding lookup against the JAX package's K1 path.

JAX runs its Pallas scan-select kernel (``_select_tile_kernel`` behind
``_planned_value``) in interpret mode at ``highest`` precision, where it is
an exact gather.  A gather has no rounding, so the port's plain version must
be bit-equal to it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.data.encoder import FeatureSpec as JaxFeatureSpec
from rec_pangu_tpu.ops import embedding as jemb
from rec_pangu_tpu.ops.kernels import embedding_grad as jgrad
from rec_pangu_tpu_torch.data.encoder import FeatureSpec
from rec_pangu_tpu_torch.ops import embedding as temb
from rec_pangu_tpu_torch.ops.kernels import _build
from rec_pangu_tpu_torch.ops.kernels import embedding_lookup as lookup

FIELDS, VOCAB, BATCH = 4, 16384, 2048  # 4 x 16,385 rows -> padded 73,728


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("REC_PANGU_TPU_EMB_GRAD_PRECISION", "highest")


def _spec(rows=(VOCAB + 1,) * FIELDS, dense=0):
    return FeatureSpec(tuple(f"s{i}" for i in range(len(rows))),
                       tuple(f"d{i}" for i in range(dense)), tuple(rows))


@pytest.mark.parametrize("dim", [8, 32])
def test_lookup_bit_equal_to_jax_k1(dim, monkeypatch):
    spec = _spec()
    num_rows = temb.padded_rows(spec.total_rows)
    assert num_rows == jgrad.padded_rows(spec.total_rows) == 73_728
    rng = np.random.default_rng(dim)
    table = rng.standard_normal((num_rows, dim)).astype(np.float32)
    sparse = rng.integers(0, VOCAB + 1, (BATCH, FIELDS)).astype(np.int32)
    fused = temb.host_fused_ids(spec, sparse)
    plan = {k: jnp.asarray(v)
            for k, v in jgrad.make_sort_plan(fused, num_rows, dim=dim).items()}
    ids = jnp.asarray(fused.reshape(BATCH, FIELDS).astype(np.int32))
    assert jgrad._scan_fwd_ok(table, ids, plan), "K1 would not run at this shape"
    calls = []
    select = jgrad._select_stream

    def counting(*args):
        calls.append(1)
        return select(*args)

    monkeypatch.setattr(jgrad, "_select_stream", counting)
    expected = np.asarray(jgrad._planned_value(jnp.asarray(table), ids, plan))
    assert calls, "the JAX lookup did not reach the Pallas select kernel"
    got = lookup.fused_embedding_lookup(torch.from_numpy(table), torch.from_numpy(sparse),
                                        torch.from_numpy(spec.offsets.copy()))
    assert got.shape == (BATCH, FIELDS, dim)
    np.testing.assert_array_equal(got.numpy(), expected)


def test_fused_embedding_matches_jax_module():
    rows = (7, 70_000, 12)  # 70,019 rows: padded to 73,728
    spec, jspec = _spec(rows), JaxFeatureSpec(_spec(rows).sparse_names, (), rows)
    dim = 8
    jmod = jemb.FusedEmbedding(jspec, dim)
    sparse = np.stack([np.arange(64) % r for r in rows], axis=1).astype(np.int32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(sparse))
    jtable = np.array(variables["params"]["table"])
    expected = np.asarray(jmod.apply(variables, jnp.asarray(sparse)))

    mod = temb.FusedEmbedding(spec, dim)
    assert tuple(mod.table.shape) == jtable.shape == (73_728, dim)
    np.testing.assert_array_equal(mod.offsets.numpy(), jspec.offsets)
    assert "offsets" not in mod.state_dict()  # derived from the spec, not a weight
    with torch.no_grad():
        mod.table.copy_(torch.from_numpy(jtable))
    np.testing.assert_array_equal(mod(torch.from_numpy(sparse)).detach().numpy(), expected)
    # kaiming: std sqrt(2/D) whatever the vocabulary size, like the JAX table
    assert abs(mod.table.std().item() / np.sqrt(2.0 / dim) - 1) < 0.02
    assert abs(jtable.std() / np.sqrt(2.0 / dim) - 1) < 0.02


def test_xavier_init_per_feature_std_matches_jax():
    rows = (40_000, 30_000, 3)  # padded 73,728: the last 3,725 rows are pad
    dim = 16
    spec, jspec = _spec(rows), JaxFeatureSpec(_spec(rows).sparse_names, (), rows)
    jvars = jemb.FusedEmbedding(jspec, dim, init_mode="xavier").init(
        jax.random.PRNGKey(1), jnp.zeros((2, 3), jnp.int32))
    jtable = np.asarray(jvars["params"]["table"])
    table = temb.FusedEmbedding(spec, dim, init_mode="xavier").table.detach().numpy()
    assert table.shape == jtable.shape == (73_728, dim)
    for t in (table, jtable):
        for i, name in enumerate(spec.sparse_names):
            sl = spec.feature_slice(name)
            want = np.sqrt(2.0 / (rows[i] + dim))
            if rows[i] > 1000:
                assert abs(t[sl].std() / want - 1) < 0.02
            else:
                assert 0 < t[sl].std() < 3 * want
        np.testing.assert_array_equal(t[spec.total_rows:], 0.0)  # pad rows


def test_out_of_range_ids():
    spec = _spec((5, 6))
    table = torch.arange(11 * 4, dtype=torch.float32).reshape(11, 4)
    offsets = torch.from_numpy(spec.offsets.copy())
    sparse = torch.tensor([[0, 5], [4, 6], [-1, 0], [5, -7]], dtype=torch.int32)
    out = lookup.fused_embedding_lookup(table, sparse, offsets)
    # fused ids 0, 10 | 4, 11 (out) | -1 (out), 5 | 5, -2 (out)
    np.testing.assert_array_equal(out[0].numpy(), table[[0, 10]].numpy())
    np.testing.assert_array_equal(out[1, 0].numpy(), table[4].numpy())
    for b, f in ((1, 1), (2, 0), (3, 1)):
        np.testing.assert_array_equal(out[b, f].numpy(), 0.0)
    with pytest.raises(ValueError, match="out of range"):
        temb.check_ids(spec, sparse.numpy(), 11)
    temb.check_ids(spec, np.array([[4, 5]]), 11)  # the last valid row
    with pytest.raises(ValueError, match="int32"):
        lookup.fused_embedding_lookup(table, sparse.long(), offsets)


def test_cpu_lookup_builds_and_launches_nothing(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU lookup must not build a kernel")

    monkeypatch.setattr(_build, "build_all", no_build)
    assert lookup.LAUNCHES == 0 and lookup._FN is None
    out = lookup.fused_embedding_lookup(torch.ones(4, 2), torch.zeros(3, 1, dtype=torch.int32),
                                        torch.zeros(1, dtype=torch.int32))
    assert out.shape == (3, 1, 2)
    assert lookup.LAUNCHES == 0 and lookup._FN is None and not _build._LIBS
