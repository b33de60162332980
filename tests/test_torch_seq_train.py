"""Training SASRec with the port against the JAX package.

The JAX sequence fused step runs only on a TPU (its gate refuses the CPU,
``tests/test_fused_adam.py``), so the port's fused step (the history rows
and the streamed CE's dense item gradient into one table Adam pass) is held
to the JAX *standard* step (``create_train_state`` + ``make_train_step``:
autograd and optax Adam over every parameter), weights carried across,
dropout 0.  After one step the parameters agree within atol 1e-6 (the same
float32 terms summed in other orders, through Adam's first step lr * g /
(|g| + eps)); over three steps the losses within rtol 1e-5.  The port's
standard step (autograd, the CE's dense gradient plus the lookup's, torch
Adam) agrees with its fused step within the same atol.  One exception: the
key projection's bias has an exact gradient of 0 (a softmax does not change
when one constant is added to a row of scores), so both sides hold rounding
noise there, which Adam's first step turns into +-lr: those biases are held
within 2 lr.  Adam's first step sees little more than each gradient's sign,
so the gradients the fused step hands on (the captured history rows and the
CE's dense item gradient, summed into the table's gradient, and every dense
weight's) are also held to ``jax.grad`` of the JAX standard loss at the
start weights, within 1e-5 of each array's largest entry (the key biases,
rounding noise on both sides, within 1e-7).
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.train.ckpt import load_checkpoint as jax_load_checkpoint
from rec_pangu_tpu.train.optim import make_optimizer as jax_make_optimizer
from rec_pangu_tpu.train.steps import create_train_state, make_train_step
from rec_pangu_tpu_torch.convert import jax_tree, jax_variables, load_jax_variables
from rec_pangu_tpu_torch.data import get_dataloader
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.train import SequenceTrainer
from rec_pangu_tpu_torch.train import fused_update
from rec_pangu_tpu_torch.train.fused_update import (SeqFusedStep, maybe_enable_seq_fused_update,
                                                    seq_fused_applicable)
from rec_pangu_tpu_torch.train.steps import StandardStep

from conftest import SEQ_SCHEMA

B, L, VOCAB, LR = 16, 12, 200, 1e-3
CONFIG = {"embedding_dim": 8, "max_length": L, "n_heads": 2, "inner_size": 16, "n_layers": 2,
          "item_col": "item_id", "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0}
ENC = {"item_id": {"vocab_size": VOCAB}}


def _batch(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, B)
    lens[4] = 0  # an empty history
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    hist = np.where(mask > 0, rng.integers(1, VOCAB, (B, L)), 0).astype(np.int32)
    return {"hist_item_list": hist, "hist_mask_list": mask,
            "target_item": rng.integers(1, VOCAB, B).astype(np.int32)}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_standard_run():
    """Three JAX standard steps from one seeded SASRec (flax encoder, naive
    CE): the weights before, the params after step 1, the three losses."""
    model = jax_get_model("SASRec")(enc_dict=ENC, config=CONFIG)
    batches = [_batch(s) for s in (10, 11, 12)]
    state = create_train_state(model, batches[0], jax_make_optimizer(LR, 1),
                               jax.random.PRNGKey(0))
    start = _numpy(state.params)

    def loss(params):  # the standard step's loss at step 0
        rngs = {"dropout": jax.random.fold_in(jax.random.PRNGKey(1), 0)}
        return model.apply({"params": params}, batches[0], True, rngs=rngs)["loss"]

    grads = _numpy(jax.grad(loss)(state.params))
    step = make_train_step(False)
    losses, after_one = [], None
    for b in batches:
        state, out = step(state, b, jax.random.PRNGKey(1))
        losses.append(float(out["loss"]))
        after_one = after_one or _numpy(state.params)
    return {"start": start, "grads": grads, "after_one": after_one, "losses": losses,
            "batches": batches}


def _port_model(params, config=CONFIG):
    model = get_model("SASRec")(enc_dict=ENC, config=config)
    load_jax_variables(model, {"params": params})
    return model.train()


def _run(model, step, batches):
    losses, after_one = [], None
    for i, batch in enumerate(batches):
        out = step(model.upload_batch(batch, torch.device("cpu"), train=True), i)
        losses.append(float(out["loss"].detach()))
        after_one = after_one or jax_variables(model)["params"]
    return losses, after_one


def _assert_params_close(got, want, atol):
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(flat_want)
    for path, arr in flat_got:
        name = jax.tree_util.keystr(path)
        key_bias = "['key']['bias']" in name  # a gradient of exactly 0: noise
        np.testing.assert_allclose(arr, flat_want[path], rtol=0,
                                   atol=2 * LR if key_bias else atol, err_msg=name)


def test_fused_step_matches_jax_standard_step(jax_standard_run):
    j = jax_standard_run
    model = _port_model(j["start"])
    step = maybe_enable_seq_fused_update(model, LR, 1)
    assert isinstance(step, SeqFusedStep)
    losses, after_one = _run(model, step, j["batches"])
    _assert_params_close(after_one, j["after_one"], 1e-6)
    np.testing.assert_allclose(losses, j["losses"], rtol=1e-5)
    state = step.opt_state(3)
    assert state["tables"]["item_emb/table"]["mu"].shape == (VOCAB, 8)
    assert state["tables"]["item_emb/table"]["dtype"] == "float32"
    assert "item_emb" not in state["params"]["mu"]


def test_fused_step_gradients_match_jax(jax_standard_run, monkeypatch):
    """What the fused step hands to torch Adam and to K3, before either runs,
    against jax.grad of the JAX standard loss at the same weights."""
    j = jax_standard_run
    model = _port_model(j["start"])
    step = maybe_enable_seq_fused_update(model, LR, 1)
    launches = []

    def record(ids, rows, table, mu, nu, hyper, dense=None):
        launches.append((ids.clone(), rows.clone(), dense.clone()))
        return adam_update(ids, rows, table, mu, nu, hyper, dense)

    adam_update = fused_update.planned_adam_update
    monkeypatch.setattr(fused_update, "planned_adam_update", record)
    step(model.upload_batch(j["batches"][0], torch.device("cpu"), train=True), 0)
    (ids, rows, dense), = launches
    assert rows.shape == (B * L, 8) and dense.shape == (VOCAB, 8)
    table_grad = dense.index_add(0, ids.long(), rows)  # history rows + the CE's gradient
    got = jax_tree(model, lambda t: table_grad if t is model.item_emb.table else t.grad)
    want = dict(jax.tree_util.tree_leaves_with_path(j["grads"]))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(want)
    for path, arr in flat_got:
        name = jax.tree_util.keystr(path)
        ref = want[path]
        atol = 1e-7 if "['key']['bias']" in name else 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(arr, ref, rtol=0, atol=atol, err_msg=name)


def test_standard_step_matches_fused_step(jax_standard_run, monkeypatch):
    j = jax_standard_run
    fused_model, std_model = _port_model(j["start"]), _port_model(j["start"])
    _, fused = _run(fused_model, maybe_enable_seq_fused_update(fused_model, LR, 1),
                    j["batches"][:1])
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ADAM", "0")
    assert maybe_enable_seq_fused_update(std_model, LR, 1) is None
    _, std = _run(std_model, StandardStep(std_model, LR, 1, generator=torch.Generator()),
                  j["batches"][:1])
    _assert_params_close(std, fused, 1e-6)


def test_gates_refuse(monkeypatch):
    model = get_model("SASRec")(enc_dict=ENC, config=CONFIG)
    assert seq_fused_applicable(model) and maybe_enable_seq_fused_update(model, LR, 1)
    assert maybe_enable_seq_fused_update(model, LR, 1, optimizer="sgd") is None
    assert maybe_enable_seq_fused_update(model, LR, 1, step=5) is None
    sampled = get_model("SASRec")(enc_dict=ENC, config={**CONFIG, "loss_type": "sampled"})
    assert maybe_enable_seq_fused_update(sampled, LR, 1) is None

    class NotCompatible(type(model)):
        fused_update_compatible = False

    assert maybe_enable_seq_fused_update(NotCompatible(ENC, CONFIG), LR, 1) is None
    for env in ("REC_PANGU_TPU_FUSED_CE", "REC_PANGU_TPU_FUSED_ADAM"):
        with monkeypatch.context() as m:
            m.setenv(env, "0")
            assert maybe_enable_seq_fused_update(model, LR, 1) is None


def test_sampled_loss_matches_jax_for_the_same_negatives():
    jmodel = jax_get_model("SASRec")(enc_dict=ENC, config={**CONFIG, "loss_type": "sampled"})
    batch = _batch(3)
    params = _numpy(jmodel.init({"params": jax.random.PRNGKey(2)}, batch, False)["params"])
    rng = np.random.default_rng(4)
    user = rng.standard_normal((B, 8)).astype(np.float32)
    k = 50
    # without a dropout key the JAX model draws its negatives from PRNGKey(0)
    want = jmodel.apply({"params": params}, jnp.asarray(user), jnp.asarray(batch["target_item"]),
                        k, method="calculate_sampled_loss")
    neg = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (k,), 1, VOCAB))
    model = _port_model(params, {**CONFIG, "loss_type": "sampled"})
    got = model.calculate_sampled_loss(torch.from_numpy(user),
                                       torch.from_numpy(batch["target_item"]), k,
                                       neg_ids=torch.from_numpy(neg))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    drawn = model.calculate_sampled_loss(torch.from_numpy(user),
                                         torch.from_numpy(batch["target_item"]), k, gen)
    assert np.isfinite(float(drawn))
    # the training loss takes the sampled branch and draws from the step's seed
    inputs = model.upload_batch(batch, torch.device("cpu"), train=True)
    a, b = (float(model(inputs, train=True, seed=s)["loss"]) for s in (1, 2))
    assert a != b and float(model(inputs, train=True, seed=1)["loss"]) == a


def test_fit_on_the_bundled_data(seq_dfs, tmp_path, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_MOMENT_DTYPE", "bf16")
    schema = {**SEQ_SCHEMA, "max_length": 20}
    loaders = get_dataloader(*seq_dfs, schema, batch_size=128)
    enc = loaders[3]
    config = {"embedding_dim": 16, "max_length": 20, "n_heads": 2, "inner_size": 16,
              "n_layers": 1}
    model = get_model("SASRec")(enc_dict=enc, config=config)
    ckpt_dir = str(tmp_path / "ckpt")
    trainer = SequenceTrainer(model_ckpt_dir=ckpt_dir, device="cpu")
    losses = []
    step = trainer._step

    def record(batch):
        out = step(batch)
        losses.append(float(out["loss"].detach()))
        return out

    trainer._step = record
    epochs, per_epoch = 3, len(loaders[0])
    assert trainer.fit(model, loaders[0], loaders[1], epoch=epochs, lr=5e-3,
                       use_earlystopping=True, max_patience=epochs,
                       monitor_metric="recall@20", seed=3) is None
    assert isinstance(trainer._train_step, SeqFusedStep)
    assert trainer.step == len(losses) == epochs * per_epoch
    means = [np.mean(losses[i * per_epoch:(i + 1) * per_epoch]) for i in range(epochs)]
    assert np.all(np.isfinite(losses)) and means[-1] < means[0]
    with open(os.path.join(ckpt_dir, "log.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["1", "2", "3"] and "recall@20" in rows[0]
    assert {"model_e_1.ckpt", "model_e_3.ckpt", "model_best.ckpt"} <= set(os.listdir(ckpt_dir))

    path = os.path.join(ckpt_dir, "model_e_3.ckpt")
    ckpt = jax_load_checkpoint(path)  # the JAX package reads it
    jax.tree_util.tree_map(np.testing.assert_array_equal, ckpt["params"],
                           jax_variables(model)["params"])
    table_state = ckpt["opt_state"]["tables"]["item_emb/table"]
    assert table_state["dtype"] == "bfloat16" and table_state["mu"].dtype == np.uint16
    for name in ("mu", "nu"):  # the bfloat16 bits, as the step holds them
        bits = torch.from_numpy(table_state[name].view(np.int16))
        assert torch.equal(bits.view(torch.bfloat16), getattr(trainer._train_step, name))
    reloaded = get_model("SASRec")(enc_dict=enc, config=config)
    SequenceTrainer(device="cpu").load_model(reloaded, path)
    batch = {k: v for k, v in next(iter(loaders[2])).items() if k.startswith("hist_")}
    with torch.no_grad():
        want = model.eval()(model.upload_batch(batch, torch.device("cpu")))["user_emb"]
        got = reloaded(reloaded.upload_batch(batch, torch.device("cpu")))["user_emb"]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("option,item", [({"mesh": object()}, "10"),
                                         ({"steps_per_call": 2}, "11")])
def test_fit_raises_for_options_not_ported(option, item, tmp_path):
    """A mesh that is no DeviceMesh from parallel.make_mesh (the sequence
    trainer's mesh is ported now, as the ranking and graph trainers' are)
    raises before fit touches anything, alone or beside steps_per_call."""
    trainer = SequenceTrainer(device="cpu", model_ckpt_dir=str(tmp_path))
    with pytest.raises(TypeError, match="mesh must be a DeviceMesh from parallel.make_mesh"):
        trainer.fit(None, None, **{"mesh": object(), **option})


def test_training_batch_checks_its_targets():
    model = get_model("SASRec")(enc_dict=ENC, config=CONFIG)
    batch = _batch(5)
    inputs = model.upload_batch(batch, torch.device("cpu"), train=True)
    assert inputs["target_item"].dtype == torch.int32 and inputs["target_item"].shape == (B,)
    batch["target_item"][0] = VOCAB
    with pytest.raises(ValueError, match="out of range"):
        model.upload_batch(batch, torch.device("cpu"), train=True)
