"""``RankTrainer.fit(mesh=...)``, ``GraphTrainer`` and ``BenchmarkTrainer``
under a mesh, against the port's single-device runs and the JAX package's
mesh fit (``test_planned_mesh.py``'s DP and TP trainer tests,
``test_trainer_mesh.py``).

Two spawns of gloo ranks on the CPU (``_torch_mesh_ranks``): two ranks run
the 2 x 1 and 1 x 2 legs, four the 2 x 2 legs.  DeepFM at 4 fields x 5,000
values, D = 8, batches of 256 rows (against JAX: 4 x 16,383 values, a
65,536-row table, batches of 2,048, where JAX's fit takes its fused step as
the port's does).  Tolerances:

* the data-parallel fused step (dropout 0.2 on the MLP) against the
  single-device step on the same global batches: the table and its Adam
  moments bit-equal after step 1 (the cotangent rows gathered in rank
  order and scaled by exactly 1/2, the stable sort, K3 on the same sums);
  dense weights within 1e-6 of each leaf's largest entry (their gradients
  are summed in another order); losses within rtol 1e-5 over three steps;
  the ranks' weights bit-equal after every step;
* against JAX's ``fit(mesh=make_mesh(2, 1))`` from JAX's initial weights
  with dropout off: ``tests/test_torch_train.py``'s tolerances (weights
  after step 1 within 1e-6, losses rtol 1e-4);
* the row-sharded standard step (1 x 2 and 2 x 2): the lookup bit-equal,
  the gathered first table gradient within 1e-6 of the single device's,
  ``evaluate_model`` within 5e-3 (JAX's ``test_trainer_mesh.py`` bound);
* BatchNorm (ShareBottom's towers, dropout on): predictions and running
  statistics after a step within 1e-6 (absolute) of the single device's;
* checkpoints: a 2 x 2 ``save_all`` holds the whole tables and loads in a
  single-device port trainer (the same metrics) and in the JAX package
  (predictions within 1e-5); a JAX ``save_all`` resumes under 2 x 2 within
  1e-6 of the single-device resume.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.parallel import make_mesh as jax_make_mesh
from rec_pangu_tpu.train import RankTrainer as JaxRankTrainer
from rec_pangu_tpu.train import optim as jax_optim
from rec_pangu_tpu.train.ckpt import load_checkpoint as jax_load_checkpoint
from rec_pangu_tpu.train.steps import create_train_state
from rec_pangu_tpu_torch.convert import jax_variables
from rec_pangu_tpu_torch.data.encoder import FeatureSpec
from rec_pangu_tpu_torch.models.pretrained import build_pretrained_matrix
from rec_pangu_tpu_torch.train import RankTrainer

import _torch_mesh_ranks as ranks

JAX_LR, JAX_SEED = 1e-3, 5
JAX_VOCAB, JAX_BATCH = 16_383, 2048  # a 65,536-row table: JAX's fused (planned) step
DENSE_REL = 1e-6
TABLE_KEYS = ("embedding.table", "mu", "nu")


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_model(vocab=ranks.VOCAB):
    return jax_get_model("DeepFM")(enc_dict=ranks.enc_dict(vocab), embedding_dim=ranks.DIM,
                                   hidden_units=ranks.HIDDEN)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's initial weights, its fit under a (2, 1) mesh on the conftest's
    8-device CPU mesh (its fused step, K1 and K3 in interpret mode at
    ``highest`` precision, as ``tests/test_torch_train.py`` runs it: losses
    and weights after step 1, recorded around the step), and a JAX save_all
    checkpoint to resume from."""
    batches = [ranks.batch(s, rows=JAX_BATCH, vocab=JAX_VOCAB) for s in (1, 2, 3)]
    state = create_train_state(_jax_model(JAX_VOCAB), batches[0],
                               jax_optim.make_optimizer(JAX_LR, 3), jax.random.PRNGKey(JAX_SEED))
    record = {"losses": [], "after_one": None}
    tmp = tmp_path_factory.mktemp("jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
        mp.setenv("REC_PANGU_TPU_EMB_GRAD_PRECISION", "highest")
        tr = JaxRankTrainer(num_task=1, model_ckpt_dir=str(tmp / "dp"))
        step_of = JaxRankTrainer._train_one_epoch

        def recording_epoch(self, *args):
            inner = self._train_step

            def run(state, batch, rng):
                state, out = inner(state, batch, rng)
                record["losses"].append(float(out["loss"]))
                if record["after_one"] is None:
                    record["after_one"] = _numpy(state.params)
                return state, out

            self._train_step = run
            return step_of(self, *args)

        mp.setattr(JaxRankTrainer, "_train_one_epoch", recording_epoch)
        tr.fit(_jax_model(JAX_VOCAB), [dict(b) for b in batches], None, epoch=1, lr=JAX_LR,
               mesh=jax_make_mesh(2, 1), seed=JAX_SEED)
    assert tr._fused_step is not None and len(record["losses"]) == 3
    ckpt_tr = JaxRankTrainer(num_task=1, model_ckpt_dir=str(tmp / "ckpt"))
    ckpt_tr.fit(_jax_model(), [ranks.batch(s) for s in (40, 41)], None, epoch=1, lr=ranks.LR,
                seed=JAX_SEED)
    ckpt_tr.save_all(None, ranks.enc_dict(), str(tmp / "ckpt"))
    return {"init": {"params": _numpy(state.params), "batches": batches, "lr": JAX_LR,
                     "vocab": JAX_VOCAB},
            "record": record, "ckpt": str(tmp / "ckpt" / "model.ckpt")}


@pytest.fixture(scope="module")
def world2(jax_side, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("world2"))
    return ranks.spawn(ranks.trainer_world2, 2, tmp, tmp=tmp, jax_init=jax_side["init"])


@pytest.fixture(scope="module")
def world4(jax_side, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("world4"))
    return ranks.spawn(ranks.trainer_world4, 4, tmp, tmp=tmp, jax_ckpt=jax_side["ckpt"])


def _close(got, want, rel, what=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# ---------------------------------------------------------- data parallel
@pytest.mark.parametrize("key", TABLE_KEYS)
def test_dp_fused_step_table_is_bit_equal(world2, key):
    dp, single = world2[0]["fused_dp"], world2[0]["fused_single"]
    assert dp["step"] == single["step"] == "FusedStep"
    np.testing.assert_array_equal(dp["after"][0][key], single["after"][0][key])


@pytest.mark.parametrize("key", ["mlp.dense.0.weight", "mlp.dense.0.bias", "mlp.dense.1.weight",
                                 "mlp.dense.1.bias", "mlp.dense.2.weight", "mlp.dense.2.bias"])
def test_dp_fused_step_dense_weights(world2, key):
    dp, single = world2[0]["fused_dp"], world2[0]["fused_single"]
    _close(dp["after"][0][key], single["after"][0][key], DENSE_REL, key)


def test_dp_losses_with_dropout(world2):
    dp, single = world2[0]["fused_dp"], world2[0]["fused_single"]
    assert len(dp["losses"]) == 3
    np.testing.assert_allclose(dp["losses"], single["losses"], rtol=1e-5)
    assert dp["metric"] == single["metric"]


@pytest.mark.parametrize("step", range(3))
def test_dp_ranks_hold_equal_weights(world2, step):
    a, b = (r["fused_dp"]["after"][step] for r in world2)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_dp_matches_jax_fit_under_mesh(world2, jax_side):
    got, want = world2[0]["jax_dp"], jax_side["record"]
    assert got["step"] == "FusedStep"
    flat_want = _flat(want["after_one"])
    flat_got = _flat(got["after"][0]["params"])
    assert flat_got.keys() == flat_want.keys()
    for key, arr in flat_got.items():
        np.testing.assert_allclose(arr, flat_want[key], rtol=0, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


# --------------------------------------------------------- row-sharded
def _tp(world2, world4, shape):
    return (world2[0]["tp12"], world2) if shape == "1x2" else (world4[0]["tp22"], world4)


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_tp_lookup_is_bit_equal(world2, world4, shape):
    key, results = ("tp12_lookup", world2) if shape == "1x2" else ("lookup", world4)
    for r in results:
        np.testing.assert_array_equal(*r[key])


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_tp_first_table_gradient(world2, world4, shape):
    leg, results = _tp(world2, world4, shape)
    assert leg["step"] == "StandardStep"
    _close(leg["grad_mesh"], leg["grad_single"], 1e-6)
    key = "tp12" if shape == "1x2" else "tp22"
    for r in results[1:]:  # every rank gathers the same whole gradient
        np.testing.assert_array_equal(r[key]["grad_mesh"], leg["grad_mesh"])


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_tp_evaluate_matches_single(world2, world4, shape):
    leg, _ = _tp(world2, world4, shape)
    for name in ("roc_auc_score", "log_loss"):
        assert abs(leg["metric_mesh"][name] - leg["metric_single"][name]) < 5e-3
    np.testing.assert_allclose(leg["preds_mesh"], leg["preds_single"], rtol=0, atol=5e-3)


def test_tp_ranks_hold_equal_weights(world4):
    """After the 2 x 2 fit: dense weights bit-equal on all four ranks, the
    table's blocks on the two data ranks of each model rank."""
    w = [r["ckpt_weights"] for r in world4]
    for key in w[0]:
        for rank in range(1, 4):
            if key == "embedding.table" and rank % 2 != 0:
                continue
            np.testing.assert_array_equal(w[rank][key], w[0][key], err_msg=key)
    np.testing.assert_array_equal(w[3]["embedding.table"], w[1]["embedding.table"])
    assert w[0]["embedding.table"].shape == (10_002, ranks.DIM)


# ------------------------------------------------- batches and BatchNorm
def test_mesh_with_partial_batches(world2):
    """91 rows in batches of 64 over two data ranks: the 27-row tail runs
    whole on each rank, as JAX places it replicated."""
    dp, single = world2[0]["partial_dp"], world2[0]["partial_single"]
    assert 0.0 <= dp["metric"]["roc_auc_score"] <= 1.0
    assert dp["preds"].shape == (91,)
    for key in single["weights"]:
        _close(dp["weights"][key], single["weights"][key], 1e-5, key)


def test_per_host_loader_shards(world2):
    """A loader built with shard_rank=<data rank>, num_shards=2 trains on the
    same rows a step as the global loader of twice its batch; a loader of
    another rank's shard is refused."""
    for r in world2:
        host = r["host_input"]
        assert host["sharded"]["steps"] == host["global"]["steps"] == 2
        for key in host["global"]["weights"]:
            _close(host["sharded"]["weights"][key], host["global"]["weights"][key], 1e-5, key)
        for name, value in host["global"]["metric"].items():
            assert abs(host["sharded"]["metric"][name] - value) < 1e-3
        assert "num_shards=2 and shard_rank" in host["refused"]


@pytest.mark.parametrize("key", ["out", "stats"])
def test_global_batch_norm_in_fit(world2, key):
    dp, single = world2[0]["bn_dp"], world2[0]["bn_single"]
    assert dp["step"] == single["step"] == "FusedStep"
    got, want = dp[key], single[key]
    names = [k for k in want if key == "out" or "running" in k]
    assert names
    for name in names:  # probabilities and statistics of order 1e-3 to 1: absolute
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(dp["losses"], single["losses"], rtol=1e-5)


# ----------------------------------------------------------- graph CF
def test_graph_fit_under_mesh(world2):
    dp, single = world2[0]["graph_fit_dp"], world2[0]["graph_fit_single"]
    np.testing.assert_allclose(dp["losses"], single["losses"], rtol=1e-5)
    for key in single["weights"]:
        if key == "g":
            continue
        _close(dp["weights"][key], single["weights"][key], 1e-5, key)


@pytest.mark.parametrize("rank", range(2))
def test_graph_evaluate_under_mesh(world2, rank):
    mesh_metric, single = world2[rank]["graph_eval"]
    assert mesh_metric == single


def test_benchmark_trainer_under_mesh(world2):
    assert [r["benchmark"]["rows"] for r in world2] == [1, 1]
    assert [r["benchmark"]["csv"] for r in world2] == [True, False]


# ---------------------------------------------------------- checkpoints
def test_mesh_checkpoint_loads_on_one_device(world4):
    """The 2 x 2 save_all holds the whole table; a single-device port
    trainer and the JAX package read it."""
    path = world4[0]["ckpt"]
    assert all(r["ckpt"] == path for r in world4) and os.path.exists(path)
    batches = [ranks.batch(s) for s in (20, 21, 22)]
    model = ranks.deepfm()
    trainer = RankTrainer(device="cpu")
    ckpt = trainer.load_model(model, path)
    assert ckpt["params"]["FusedEmbedding_0"]["table"].shape == (20_004, ranks.DIM)
    assert ckpt["opt_state"]["params"]["mu"]["FusedEmbedding_0"]["table"].shape == (20_004,
                                                                                   ranks.DIM)
    assert trainer.evaluate_model(model, batches) == world4[0]["tp22"]["metric_mesh"]
    np.testing.assert_array_equal(model.embedding.table.detach().numpy()[10_002:],
                                  world4[1]["ckpt_weights"]["embedding.table"])
    preds = trainer.predict_dataloader(model, batches)
    jax_ckpt = jax_load_checkpoint(path)
    jpreds = np.concatenate([np.asarray(_jax_model().apply(
        {"params": jax_ckpt["params"]}, {k: jnp.asarray(b[k]) for k in ("sparse", "dense")},
        False)["pred"]).reshape(-1) for b in batches])
    np.testing.assert_allclose(jpreds, preds, rtol=0, atol=1e-5)
    assert set(jax_variables(model)["params"]) == set(jax_ckpt["params"])


@pytest.mark.parametrize("col", ranks.FROZEN_COLS)
def test_frozen_pretrained_rows_under_tp(world4, col):
    """set_pretrained_weights(trainable=False) under 2 x 2: the rows, written
    into the whole table before fit shards it, stay as written in each
    model rank's block; the other rows train."""
    enc = ranks.enc_dict()
    rows = FeatureSpec.from_enc_dict(enc).feature_slice(col)
    want = build_pretrained_matrix(enc, col, ranks.PRETRAINED)
    for r in world4:
        assert r["frozen"]["step"] == "StandardStep"
        np.testing.assert_array_equal(r["frozen"]["table"][rows], want)
    initial = ranks.deepfm().embedding.table.detach().numpy()
    assert not np.array_equal(world4[0]["frozen"]["table"][:5001], initial[:5001])


@pytest.mark.parametrize("rank", range(4))
def test_jax_checkpoint_resumes_under_mesh(world4, rank):
    got, want = world4[rank]["resume_mesh"], world4[rank]["resume_single"]
    assert got["step"] == want["step"] == 4  # the checkpoint's two steps, then two
    flat_got, flat_want = _flat(got["params"]), _flat(want["params"])
    assert flat_got.keys() == flat_want.keys()
    for key, arr in flat_got.items():
        _close(arr, flat_want[key], 1e-6, key)
