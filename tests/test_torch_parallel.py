"""The port's mesh (``rec_pangu_tpu_torch/parallel``) against the JAX
package's ``parallel`` tests (``test_parallel.py``, ``test_distributed_eval.py``)
and against the port's own single-device paths.

One spawn of four gloo ranks on the CPU (``_torch_mesh_ranks.parallel_world4``)
runs every check on a 2 x 2 and a 4 x 1 mesh; the tests below hold each
rank's arrays:

* the mesh's coordinates, and the collectives' stated backwards: an
  identity over ``model`` (a summing backward would hand each shard
  ``n_model`` times its gradient) and a sum over ``data``;
* the row-sharded lookup and its block's table gradient, bit-equal to the
  whole table's;
* ``distributed_topk`` and ``distributed_masked_topk`` (61 items padded to
  62) against ``torch.topk`` / ``masked_topk`` on the whole table and
  against the JAX package's on its 8-device CPU mesh: the same ids (the
  inputs have no near-ties: the gaps between the ranked scores are checked
  first), scores within 1e-5;
* BatchNorm on the global batch's statistics with dropout on global rows:
  the blocks' outputs, running statistics and summed gradients within 1e-6
  (of each leaf's largest entry) of the whole batch's;
* ``get_recall_predict(mesh=...)`` equal to the single-device lists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.parallel import make_mesh as jax_make_mesh
from rec_pangu_tpu.parallel.topk import distributed_masked_topk as jax_masked_topk
from rec_pangu_tpu.parallel.topk import distributed_topk as jax_topk
from rec_pangu_tpu.parallel.topk import pad_to_multiple as jax_pad
from rec_pangu_tpu_torch.parallel import initialize_multihost, make_mesh, pad_to_multiple
from rec_pangu_tpu_torch.train import GraphTrainer, RankTrainer

import _torch_mesh_ranks as ranks

WORLD = 4
RANKS = range(WORLD)
USERS, ITEMS, D, K, SEEN = 16, 61, 8, 10, 5
ATOL = 1e-6


def _topk_inputs():
    rng = np.random.default_rng(1)
    users = rng.standard_normal((USERS, D)).astype(np.float32)
    items = rng.standard_normal((ITEMS, D)).astype(np.float32)
    seen = np.where(rng.random((USERS, SEEN)) < 0.8, rng.integers(0, ITEMS, (USERS, SEEN)),
                    ITEMS)
    return {"users": users, "items": items, "seen": seen, "k": K}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = _topk_inputs()
    results = ranks.spawn(ranks.parallel_world4, WORLD, str(tmp_path_factory.mktemp("mesh")),
                          topk=inputs)
    mesh = jax_make_mesh(2, 2)
    items = jax_pad(jnp.asarray(inputs["items"]), 2)
    with mesh:
        jax_plain = jax_topk(mesh, jnp.asarray(inputs["users"]), items, K, num_valid=ITEMS)
        jax_masked = jax_masked_topk(mesh, jnp.asarray(inputs["users"]), items,
                                     jnp.asarray(inputs["seen"]), K, num_valid=ITEMS)
    return {"ranks": results, "inputs": inputs,
            "jax": {"topk": [np.asarray(x) for x in jax_plain],
                    "masked_topk": [np.asarray(x) for x in jax_masked]}}


@pytest.mark.parametrize("rank", RANKS)
def test_mesh_coordinates(world, rank):
    r = world["ranks"][rank]
    assert r["coords"] == (rank // 2, rank % 2, (2, 2), ("data", "model"), (2, 2))
    assert r["bad_shape"] == "a (3, 1) mesh needs 3 ranks, the world has 4"


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("name", ["reduce_model", "reduce_data"])
def test_collective_backward_rules(world, name, rank):
    """y = sum of the group's x; d(sum of y * w)/dx is w over ``model``
    (identity) and the sum of the group's w over ``data``."""
    base, w = np.array([1.0, 2.0, 3.0]), np.array([1.0, 10.0, 100.0])
    d, m = rank // 2, rank % 2
    group = [d * 2, d * 2 + 1] if name == "reduce_model" else [m, 2 + m]
    y, grad = world["ranks"][rank][name]
    np.testing.assert_array_equal(y, base * sum(r + 1 for r in group))
    want = w * (rank + 1) if name == "reduce_model" else w * sum(r + 1 for r in group)
    np.testing.assert_array_equal(grad, want)


@pytest.mark.parametrize("rank", RANKS)
def test_gather_and_mean_over_data(world, rank):
    r, m = world["ranks"][rank], rank % 2
    np.testing.assert_array_equal(r["gather_rows"], np.repeat([[m], [m], [2 + m], [2 + m]], 3, 1))
    np.testing.assert_array_equal(r["all_reduce_grads"], np.full(3, (m + 2 + m) / 2))
    assert r["mean_over"] == (m + 2 + m) / 2


@pytest.mark.parametrize("rank", RANKS)
def test_sharded_lookup_is_bit_equal(world, rank):
    r = world["ranks"][rank]
    assert r["shard_rows"] == ((rank % 2) * 10_002, 10_002, 20_004)
    np.testing.assert_array_equal(*r["lookup"])
    np.testing.assert_array_equal(*r["lookup_grad"])


def test_state_shardings(world):
    r = world["ranks"][0]
    assert r["shardings"]["FusedEmbedding_0/table"] == "rows"
    assert {v for k, v in r["shardings"].items() if k != "FusedEmbedding_0/table"} == {
        "replicated"}
    assert r["shardings_odd"] == {"table": "replicated"}  # 5 rows do not divide 2


def _single_topk(inputs, masked):
    scores = inputs["users"].astype(np.float64) @ inputs["items"].T.astype(np.float64)
    if masked:
        for u, row in enumerate(inputs["seen"]):
            scores[u, row[row < ITEMS]] = -np.inf
    order = np.argsort(-scores, axis=1)[:, :K + 1]
    top = np.take_along_axis(scores, order, axis=1)
    return order[:, :K], top


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("name", ["topk", "masked_topk"])
def test_distributed_topk(world, name, rank):
    masked = name == "masked_topk"
    ids, top = _single_topk(world["inputs"], masked)
    gaps = np.diff(-top, axis=1)
    assert gaps[np.isfinite(gaps)].min() > 1e-4, "near-ties would make the ids ambiguous"
    r = world["ranks"][rank][name]
    np.testing.assert_array_equal(r[1], ids)
    np.testing.assert_array_equal(r[1], world["jax"][name][1])
    np.testing.assert_array_equal(r[-1][:, :K] if masked else r[3], ids)
    np.testing.assert_allclose(r[0], world["jax"][name][0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("key", ["train_out", "eval_out", "stats", "grads"])
@pytest.mark.parametrize("rank", RANKS)
def test_global_batch_norm(world, key, rank):
    """A 4 x 1 mesh's blocks against the whole batch of 64 rows, dropout
    0.3 on global rows.  The Linear biases right before a BatchNorm have a
    gradient of 0 analytically (the normalization undoes a shift): both
    are rounding noise, held within 1e-6 of the kernels' largest entry."""
    got, want = world["ranks"][rank]["bn"][key]
    if key in ("train_out", "eval_out"):
        got, want = [got], [want]
    scale = max(np.abs(w).max() for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        largest = np.abs(w).max()
        zero = largest <= 1e-4 * scale  # an analytic zero: rounding noise on both sides
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * (scale if zero else largest),
                                   err_msg=f"{key}[{i}]")


@pytest.mark.parametrize("rank", RANKS)
def test_row_seed_dropout_draws_the_global_rows(world, rank):
    got, want = world["ranks"][rank]["row_seed"]
    assert 0.3 < (got == 0).mean() < 0.7
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rank", RANKS)
def test_mesh_retrieval_matches_single(world, rank):
    mesh_preds, single = world["ranks"][rank]["recall"]
    assert list(mesh_preds) == list(single) and len(single) == 96
    assert mesh_preds == single


def test_pad_to_multiple_matches_jax():
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    for mult in (1, 2, 4, 5):
        np.testing.assert_array_equal(pad_to_multiple(torch.from_numpy(x), mult).numpy(),
                                      np.asarray(jax_pad(jnp.asarray(x), mult)))
    np.testing.assert_array_equal(pad_to_multiple(torch.from_numpy(x), 4, dim=1, value=-1.0)
                                  .numpy(), np.asarray(jax_pad(jnp.asarray(x), 4, axis=1,
                                                               value=-1.0)))


@pytest.mark.parametrize("entry", ["make_mesh", "initialize_multihost", "RankTrainer",
                                   "GraphTrainer"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without CUDA the entry points raise unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"make_mesh": lambda: make_mesh(2, 1),
             "initialize_multihost": lambda: initialize_multihost("localhost:1", 1, 0),
             "RankTrainer": RankTrainer, "GraphTrainer": GraphTrainer}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh(1, 1, device="cpu")
