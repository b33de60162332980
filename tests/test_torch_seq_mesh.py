"""``SequenceTrainer.fit(mesh=...)`` for the 18 sequence models, against the
port's single-device fits and the JAX package's mesh fit
(``test_planned_mesh.py``'s SASRec and GRU4Rec legs,
``test_sequence_models.py``'s SRGNN leg).

Two spawns of gloo ranks on the CPU (``_torch_mesh_ranks.spawn``, bodies in
``_torch_seq_mesh_ranks``): two ranks run the 2 x 1 and 1 x 2 legs, four
the 2 x 2 SASRec leg.  The models at a few layers, D = 8, L = 8, a 64-item
table (a 256-item one for evaluation, which ranks the top 200), two
batches of 16 rows, lr 1e-2, each model's dropout sites on at 0.2.
Tolerances:

* each model's mesh fit against its single-device fit on the same global
  batches (the sequence fused step under 2 x 1, the standard step over the
  row-sharded item table under 1 x 2): losses within rtol 1e-5; the
  weights after the fit within 1e-5 of each leaf's largest entry, but for
  the leaves whose gradient is exactly 0 (``ZERO_GRADIENT``: a softmax does
  not change when all its scores move by one constant), where Adam turns
  rounding noise into moves of up to lr a step: within 2 lr a step;
* against JAX's ``fit(mesh=make_mesh(2, 1))`` from JAX's initial weights
  with dropout off (SASRec, GRU4Rec, SRGNN; JAX takes its standard step
  at this size, the port its fused step): losses within rtol 1e-5, the
  weights after two steps within ``test_planned_mesh.py``'s own bounds
  for a mesh fit against another (rtol 2e-4, atol 2e-5: the GRU leaves
  gradients near Adam's eps, where rounding moves an entry by up to
  2.4e-5 here), the leaves of zero gradient as above;
* the kernels' plain versions at ``first = r * b`` bit-equal to rows r*b..
  of the whole batch's; the host keys bit-equal to the single-device
  draws' rows; the row-sharded item lookup bit-equal; the row-sharded CEs'
  losses within rtol 1e-6 and gradients within 1e-6 of each array's
  largest entry; ``evaluate_model`` and the top-200 lists of the same
  weights under a mesh equal to the single device's; a mesh checkpoint's
  weights equal to the gathered tables.
"""
import os

import jax
import numpy as np
import pytest

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.parallel import make_mesh as jax_make_mesh
from rec_pangu_tpu.parallel.mesh import set_active_mesh
from rec_pangu_tpu.train import SequenceTrainer as JaxSequenceTrainer
from rec_pangu_tpu.train import optim as jax_optim
from rec_pangu_tpu.train.steps import create_train_state
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.train import SequenceTrainer

import _torch_mesh_ranks as ranks
import _torch_seq_mesh_ranks as seq

LOSS_RTOL, WEIGHT_REL = 1e-5, 1e-5
STEPS = 2
ZERO_GRADIENT = ("key/bias", "K_linear/bias", "ln2/bias", "layer_norm_2/bias")
JAX_VOCAB, JAX_ROWS, JAX_LR, JAX_SEED = 4096, 64, 1e-2, 5
JAX_LEGS = {
    "SASRec": {**seq.BASE, "n_layers": 1, "n_heads": 2, "inner_size": 16,
               "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0},
    "GRU4Rec": seq.BASE,
    "SRGNN": seq.BASE,
}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _assert_weights(got: dict, want: dict, steps: int = STEPS, lr: float = seq.LR,
                    planned_mesh_bounds: bool = False):
    assert got.keys() == want.keys()
    for key, ref in want.items():
        if key.endswith(ZERO_GRADIENT):
            np.testing.assert_allclose(got[key], ref, rtol=0, atol=2 * lr * steps, err_msg=key)
        elif planned_mesh_bounds:
            np.testing.assert_allclose(got[key], ref, rtol=2e-4, atol=2e-5, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], ref, rtol=0,
                                       atol=WEIGHT_REL * max(np.abs(ref).max(), 1e-30),
                                       err_msg=key)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """For each JAX leg: JAX's initial weights (its fit's
    ``create_train_state``) and its fit under a (2, 1) mesh of the
    conftest's 8 CPU devices: each step's loss and the weights after it."""
    legs = {}
    for name, config in JAX_LEGS.items():
        batches = [seq.seq_batch(700 + s, rows=JAX_ROWS, vocab=JAX_VOCAB) for s in range(STEPS)]
        model = jax_get_model(name)(enc_dict=seq.enc_dict(JAX_VOCAB), config=dict(config))
        state = create_train_state(model, dict(batches[0]),
                                   jax_optim.make_optimizer(JAX_LR, STEPS),
                                   jax.random.PRNGKey(JAX_SEED), train=True)
        losses = []
        build = JaxSequenceTrainer._build_state

        def recording_build(self, *a, **kw):
            build(self, *a, **kw)
            inner = self._train_step

            def run(state, batch, rng):
                state, out = inner(state, batch, rng)
                losses.append(float(out["loss"]))
                return state, out

            self._train_step = run

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JaxSequenceTrainer, "_build_state", recording_build)
            tr = JaxSequenceTrainer(model_ckpt_dir=str(tmp_path_factory.mktemp(name)))
            try:
                tr.fit(model, [dict(b) for b in batches], None, epoch=1, lr=JAX_LR,
                       seed=JAX_SEED, mesh=jax_make_mesh(2, 1))
            finally:
                set_active_mesh(None)
        assert getattr(tr, "_fused_step", None) is None and len(losses) == STEPS
        legs[name] = {"init": {"config": config, "vocab": JAX_VOCAB, "batches": batches,
                               "seed": JAX_SEED,
                               "params": jax.tree_util.tree_map(np.asarray, state.params)},
                      "losses": losses, "params": _flat(jax.device_get(tr.state.params))}
    return legs


@pytest.fixture(scope="module")
def world2(jax_side, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("seq_world2"))
    return ranks.spawn(seq.seq_world2, 2, tmp, tmp=tmp,
                       jax_init={k: v["init"] for k, v in jax_side.items()})


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("seq_world4"))
    return ranks.spawn(seq.seq_world4, 4, tmp, tmp=tmp)


def _single(world, name):
    return next(r[f"{name}/single"] for r in world if f"{name}/single" in r)


# ---------------------------------------------------------- every model
@pytest.mark.parametrize("shape", ["2x1", "1x2"])
@pytest.mark.parametrize("name", seq.NAMES)
def test_mesh_fit_matches_single_device(world2, name, shape):
    tag = "dp" if shape == "2x1" else "tp"
    got, want = world2[0][f"{name}/{tag}"], _single(world2, name)
    assert want["step"] == "SeqFusedStep"
    assert got["step"] == ("SeqFusedStep" if tag == "dp" else "StandardStep")
    assert len(got["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    _assert_weights(got["params"], want["params"])
    other = world2[1][f"{name}/{tag}"]  # the ranks end with the same weights
    assert other["losses"] == got["losses"]
    for key, arr in got["params"].items():
        np.testing.assert_array_equal(other["params"][key], arr, err_msg=key)


@pytest.mark.parametrize("name", list(JAX_LEGS))
def test_mesh_fit_matches_jax(world2, jax_side, name):
    got, want = world2[0][f"jax/{name}"], jax_side[name]
    assert got["step"] == "SeqFusedStep"
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    _assert_weights(got["params"], want["params"], lr=JAX_LR, planned_mesh_bounds=True)


def test_sasrec_2x2(world4):
    """Data and model axes at once: the standard step on each data rank's
    block over the row-sharded table, dropout on."""
    want = world4[0]["single"]
    for r in world4:
        assert r["mesh"]["step"] == "StandardStep"
        np.testing.assert_allclose(r["mesh"]["losses"], want["losses"], rtol=LOSS_RTOL)
        _assert_weights(r["mesh"]["params"], want["params"])


# ------------------------------------------------------- the pieces
@pytest.mark.parametrize("kernel", ["encoder", "global_attn"])
def test_first_row_dropout_masks(world2, kernel):
    for r in world2:
        np.testing.assert_array_equal(*r["first_row"][kernel])


def _assert_single_device_rows(block: dict, want: dict, lo: int) -> None:
    b = seq.BATCH // 2
    assert block.keys() == want.keys()
    for key, arr in want.items():
        arr = np.asarray(arr)
        if key == "aug_all":
            arr = arr.reshape(3, seq.BATCH, -1)[:, lo:lo + b].reshape(3 * b, -1)
        else:
            arr = arr[lo:lo + b]
        np.testing.assert_array_equal(np.asarray(block[key]), arr, err_msg=key)


@pytest.mark.parametrize("name", ["IOCRec", "CMI", "CLRec", "SRGNN"])
def test_host_keys_are_the_single_device_rows(world2, name):
    """aug_all (each view's block), neg_items, lookup_all and the session
    graph of a mesh step are rows of the single device's draws."""
    for rank, r in enumerate(world2):
        leg = r["host_keys"][name]
        assert leg["split"] and leg["first"] == rank * (seq.BATCH // 2)
        _assert_single_device_rows(leg["block"], leg["want"], leg["first"])


@pytest.mark.parametrize("name", ["IOCRec", "CMI", "CLRec", "SRGNN"])
def test_sharded_loader_host_keys_are_the_single_device_rows(world2, name):
    """Under a loader sharded over the data ranks each rank holds only its
    rows: the views and negatives are drawn for the ranks' rows gathered
    in rank order, so each rank's keys are still its rows of the single
    device's draws (no two ranks share a stream)."""
    for rank, r in enumerate(world2):
        leg = r["host_keys"][name]
        _assert_single_device_rows(leg["presplit"], leg["want"], rank * (seq.BATCH // 2))


def test_sharded_item_lookup_is_bit_equal(world2):
    for rank, r in enumerate(world2):
        ops = r["sharded_ops"]
        assert ops["rows"] == (rank * 30, 60)
        np.testing.assert_array_equal(*ops["lookup"])


@pytest.mark.parametrize("loss", ["ce", "multimax"])
def test_sharded_softmax_ce(world2, loss):
    """The streamed CE and the K-max CE over the rank's rows of a 1 x 2
    sharded table: the loss, the user gradient and the gathered table
    gradient against the whole table's, the same on both ranks."""
    for r in world2:
        got = r["sharded_ops"][loss]
        np.testing.assert_allclose(*got["loss"], rtol=1e-6)
        for key in ("du", "dtable"):
            arr, ref = got[key]
            np.testing.assert_allclose(arr, ref, rtol=0, atol=1e-6 * np.abs(ref).max(),
                                       err_msg=key)
    for key in ("du", "dtable"):
        np.testing.assert_array_equal(world2[0]["sharded_ops"][loss][key][0],
                                      world2[1]["sharded_ops"][loss][key][0])


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
@pytest.mark.parametrize("name", ["SASRec", "ComirecSA"])
def test_evaluate_under_mesh(world2, name, shape):
    """A fit with a valid loader under the mesh (evaluate_model each epoch,
    log.csv and checkpoints from rank 0); then the single device's trained
    weights sharded over the mesh: the same metrics and top-200 lists."""
    tag = "dp" if shape == "2x1" else "tp"
    for rank, r in enumerate(world2):
        leg = r["eval"][f"{name}/{tag}"]
        assert leg["log"] == (rank == 0)
        assert leg["same_weights"]["metric"] == leg["same_weights"]["single_metric"]
        assert leg["same_weights"]["preds"] == leg["same_weights"]["single_preds"]
        single = r["eval"][f"{name}/single"]
        _assert_weights(leg["params"], single["params"], steps=2 * STEPS)
        for k, v in single["metric"].items():
            assert abs(leg["metric"][k] - v) <= 0.07, k  # one user of 32 either way


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_mesh_checkpoint_loads_on_one_device(world2, shape):
    """Rank 0's model_e_2 checkpoint of a mesh fit holds the whole item
    table; a single-device trainer reads it into an unsharded model."""
    tag = "dp" if shape == "2x1" else "tp"
    leg = world2[0]["eval"][f"SASRec/{tag}"]
    model = get_model("SASRec")(enc_dict=seq.enc_dict(seq.EVAL_VOCAB),
                                config=dict(seq.ZOO[0][1]))
    ckpt = SequenceTrainer(device="cpu").load_model(model, leg["ckpt"])
    whole = (seq.EVAL_VOCAB, seq.DIM)
    assert ckpt["params"]["item_emb"]["table"].shape == whole
    opt = ckpt["opt_state"]
    if tag == "dp":  # the fused step's table moments
        assert np.asarray(opt["tables"]["item_emb/table"]["mu"]).shape == whole
    else:  # the standard step's
        assert np.asarray(opt["params"]["mu"]["item_emb"]["table"]).shape == whole
    got = _flat(ckpt["params"])
    for key, arr in leg["params"].items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
