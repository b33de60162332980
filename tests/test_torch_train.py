"""Training with the port against the JAX package: schedules, optimizers, the
fused train step, and the flow of ``RankTrainer.fit``.

The JAX fused step runs its Pallas kernels (K1 forward, K3 table Adam) in
interpret mode at ``highest`` precision, set by the tests themselves.  After
one step the parameters agree within 1e-6: the gradients are the same f32
terms summed in other orders, and Adam's first step is lr * g / (|g| + eps),
so a rounding difference moves a parameter by far less than that unless a
gradient is within rounding of zero.  Over three steps the losses agree
within rtol 1e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.ops.embedding import attach_emb_plan
from rec_pangu_tpu.train import optim as jax_optim
from rec_pangu_tpu.train.ckpt import load_checkpoint as jax_load_checkpoint
from rec_pangu_tpu.train.fused_update import maybe_enable_fused_update as jax_enable_fused
from rec_pangu_tpu.train.steps import create_train_state
from rec_pangu_tpu_torch.convert import jax_variables, load_jax_variables
from rec_pangu_tpu_torch.data import get_dataloader
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.train import RankTrainer, optim
from rec_pangu_tpu_torch.train.fused_update import FusedStep, maybe_enable_fused_update
from rec_pangu_tpu_torch.train.steps import StandardStep

from conftest import RANKING_SCHEMA

FIELDS, VOCAB, DENSE, DIM, BATCH = 4, 16384, 2, 8, 2048
HIDDEN = (16, 16)
LR = 1e-3

SCHEDULES = {
    "": None,
    "StepLR": {"step_size": 2, "gamma": 0.5},
    "ExponentialLR": {"gamma": 0.8},
    "CosineAnnealingLR": {"T_max": 5, "eta_min": 1e-5},
}


@pytest.mark.parametrize("kind", list(SCHEDULES))
def test_lr_schedule_equals_jax(kind):
    want = jax_optim.make_lr_schedule(LR, 10, kind, SCHEDULES[kind])
    got = optim.make_lr_schedule(LR, 10, kind, SCHEDULES[kind])
    for step in (0, 1, 9, 10, 11, 25, 49, 99, 250):
        assert got(step) == want(step), (kind, step)
    with pytest.raises(ValueError, match="Unknown scheduler"):
        optim.make_lr_schedule(LR, 10, "OneCycleLR")


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "adagrad"])
def test_optimizer_steps_match_optax(name):
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) for _ in range(3)]
    tx = jax_optim.make_optimizer(0.01, 1, optimizer=name)
    w, state = jnp.asarray(w0), None
    state = tx.init(w)
    param = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = optim.make_optimizer([param], 0.01, name)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, w)
        w = w + upd
        optim.set_lr(opt, 0.01)
        param.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)


def _enc_dict():
    enc = {f"s{f}": {"vocab_size": VOCAB} for f in range(FIELDS)}
    enc.update({f"d{d}": {"min": 0.0, "max": 1.0} for d in range(DENSE)})
    return enc


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"sparse": rng.integers(0, VOCAB + 1, (BATCH, FIELDS)).astype(np.int32),
            "dense": rng.random((BATCH, DENSE)).astype(np.float32),
            "label": rng.integers(0, 2, BATCH).astype(np.float32)}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_fused_run():
    """Three JAX fused steps (K1 and K3 in interpret mode) from one seeded
    DeepFM: the weights before, the params after step 1, the three losses."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
        mp.setenv("REC_PANGU_TPU_EMB_GRAD_PRECISION", "highest")
        model = jax_get_model("DeepFM")(enc_dict=_enc_dict(), embedding_dim=DIM,
                                        hidden_units=HIDDEN)
        batches = [_batch(s) for s in (10, 11, 12)]
        state = create_train_state(model, batches[0], jax_optim.make_optimizer(LR, 1),
                                   jax.random.PRNGKey(0))
        planned = [attach_emb_plan(dict(b), model.spec, DIM) for b in batches]
        assert all("emb_plan" in b for b in planned), "the JAX gate must take the fused path"
        state, step, _ = jax_enable_fused(state, model, planned[0], LR, 1)
        assert step is not None, "the JAX fused step did not engage"
        start = _numpy(state.params)
        losses, after_one = [], None
        for b in planned:
            state, out = step(state, b, jax.random.PRNGKey(1))
            losses.append(float(out["loss"]))
            after_one = after_one or _numpy(state.params)
    return {"start": start, "after_one": after_one, "losses": losses, "batches": batches}


def _port_model(params):
    model = get_model("DeepFM")(enc_dict=_enc_dict(), embedding_dim=DIM, hidden_units=HIDDEN)
    load_jax_variables(model, {"params": params})
    return model


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
        np.testing.assert_allclose(arr, flat_want[path], rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_fused_step_matches_jax_fused_step(jax_fused_run):
    j = jax_fused_run
    model = _port_model(j["start"])
    step = maybe_enable_fused_update(model, LR, 1)
    assert isinstance(step, FusedStep)
    losses, after_one = _run(model, step, j["batches"])
    _assert_params_close(after_one, j["after_one"], 1e-6)
    np.testing.assert_allclose(losses, j["losses"], rtol=1e-4)
    state = step.opt_state(3)
    assert state["tables"]["FusedEmbedding_0/table"]["mu"].shape == (73_728, DIM)
    assert state["params"]["mu"]["MLP_0"]["Dense_0"]["kernel"].shape == (FIELDS * DIM + DENSE,
                                                                          HIDDEN[0])
    assert "FusedEmbedding_0" not in state["params"]["mu"]


def test_standard_step_matches_fused_step(jax_fused_run, monkeypatch):
    j = jax_fused_run
    fused_model, std_model = _port_model(j["start"]), _port_model(j["start"])
    _, fused = _run(fused_model, maybe_enable_fused_update(fused_model, LR, 1),
                    j["batches"][:1])
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ADAM", "0")
    assert maybe_enable_fused_update(std_model, LR, 1) is None
    _, std = _run(std_model, StandardStep(std_model, LR, 1), j["batches"][:1])
    _assert_params_close(std, fused, 1e-6)


class _TwoLookups(torch.nn.Module):
    """A model that looks its table up twice: the fused step must refuse it."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.embedding = inner.embedding

    def forward(self, batch, train=False, capture=None, seed=None):
        self.embedding(batch["sparse"], capture)
        return self.inner(batch, train, capture, seed)


def test_gate(monkeypatch):
    model = get_model("DeepFM")(enc_dict=_enc_dict(), embedding_dim=DIM, hidden_units=HIDDEN)
    assert maybe_enable_fused_update(model, LR, 1) is not None
    assert maybe_enable_fused_update(torch.nn.Linear(2, 1), LR, 1) is None
    twice = _TwoLookups(model)
    step = maybe_enable_fused_update(twice, LR, 1)
    with pytest.raises(ValueError, match="exactly one lookup"):
        step(model.upload_batch(_batch(0), torch.device("cpu"), train=True), 0)
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ADAM", "0")
    assert maybe_enable_fused_update(model, LR, 1) is None


def test_fit_flow_on_the_ranking_csv(ranking_df, tmp_path):
    train_df, valid_df, test_df = ranking_df[:80], ranking_df[:90], ranking_df[:95]
    train_loader, valid_loader, test_loader, enc_dict = get_dataloader(
        train_df, valid_df, test_df, RANKING_SCHEMA, batch_size=512)
    model = get_model("DeepFM")(enc_dict=enc_dict, embedding_dim=16, hidden_units=(32, 32))
    ckpt_dir = str(tmp_path / "ckpt")
    trainer = RankTrainer(num_task=1, model_ckpt_dir=ckpt_dir, device="cpu")
    metric = trainer.fit(model, train_loader, valid_loader, epoch=60, lr=1e-3,
                         use_earlystopping=True, max_patience=20,
                         monitor_metric="roc_auc_score")
    assert set(metric) == {"train_roc_auc_score", "train_log_loss"}
    assert metric["train_roc_auc_score"] > 0.95
    epochs = trainer.step  # 80 rows: one batch, one step per epoch
    assert trainer._train_step.fused and epochs >= 21
    files = set(os.listdir(ckpt_dir))
    assert {"model_best.ckpt", "model_e_1.ckpt", f"model_e_{epochs}.ckpt"} <= files

    path = trainer.save_all(model, enc_dict, ckpt_dir)
    ckpt = jax_load_checkpoint(path)  # the JAX package reads it
    assert ckpt["enc_dict"] == enc_dict and ckpt["step"] == trainer.step
    jax.tree_util.tree_map(np.testing.assert_array_equal, ckpt["params"],
                           jax_variables(model)["params"])
    assert ckpt["opt_state"]["layout"] == "rec_pangu_tpu_torch/adam-1"
    want = trainer.predict_dataloader(model, test_loader)
    jmodel = jax_get_model("DeepFM")(enc_dict=enc_dict, embedding_dim=16, hidden_units=(32, 32))
    jpreds = np.concatenate([np.asarray(jmodel.apply(
        {"params": ckpt["params"]}, {k: jnp.asarray(v) for k, v in b.items()
                                     if k in ("sparse", "dense")}, False)["pred"]).reshape(-1)
        for b in test_loader])
    np.testing.assert_allclose(jpreds, want, rtol=0, atol=1e-5)

    reloaded = get_model("DeepFM")(enc_dict=enc_dict, embedding_dim=16, hidden_units=(32, 32))
    RankTrainer(device="cpu").load_model(reloaded, path)
    np.testing.assert_array_equal(
        RankTrainer(device="cpu").predict_dataloader(reloaded, test_loader), want)


@pytest.mark.parametrize("option", [{"resume_from": "model.ckpt"}, {"mesh": object()},
                                    {"steps_per_call": 2}])
def test_fit_raises_for_options_not_ported(option, tmp_path):
    """Every option is ported now; a mesh that is not one of
    ``parallel.make_mesh`` raises before fit touches anything, alone or
    beside the other options (``tests/test_torch_trainer_mesh.py`` runs
    fit under real meshes)."""
    trainer = RankTrainer(device="cpu", model_ckpt_dir=str(tmp_path))
    with pytest.raises(TypeError, match="DeviceMesh from parallel.make_mesh"):
        trainer.fit(None, None, **{"mesh": object(), **option})
