"""The multi-task zoo of the port against the JAX package's models.

ShareBottom, ESSM, MMOE, OMOE, MLMMOE and AITM are built by both packages
at a small size (4 fields, 2 dense features, D=8, towers of (16, 8), AITM's
of (16, 16, 16)) with dropout off on both sides; the port loads the JAX
model's variables with ``convert.py``.  Tolerances, float32 on both sides
summed in other orders:

* eval ``task{i}_pred`` within atol 1e-5 (BatchNorm statistics moved away
  from their init), and ``jax_variables`` gives the variables back unchanged;
* the training loss within rtol 1e-5 and the first step's gradients within
  1e-5 of each leaf's largest entry (JAX at ``highest`` precision), but the
  biases before a tower's last BatchNorm (a tower has no activation) and
  OMOE's expert bias (through its input-independent gate): their gradient
  is 0 analytically (the BatchNorm undoes any shift), rounding noise on
  both sides, held within atol 1e-6 as AFN's ``log_bn/bias`` is;
* three ``FusedStep`` steps against three JAX fused steps (K1 and K3 in
  interpret mode at ``highest`` precision): the losses within rtol 1e-5;
  the parameters and the towers' BatchNorm statistics after one step
  within atol 1e-6 on all but HANDFUL elements, none past 2 lr.  Adam's
  first step is lr g / (|g| + 1e-8): a leaf whose gradient is 0
  analytically moves lr times the sign of its rounding (held within 2 lr
  only), and an element whose gradient is a few 1e-8 (a BatchNorm's
  backward subtracts batch means from it, so its rounding is of the
  batch's largest terms) moves up to 2 lr apart (measured: 7 of 589,824
  table elements at most, the largest 4.5e-5 apart, their gradients 5e-8
  to 2e-7 against 6.5e-3);
* ``RankTrainer(num_task=2)`` fits, evaluates and predicts MMOE on the
  bundled multi-task sample.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.ops.embedding import attach_emb_plan
from rec_pangu_tpu.train import optim as jax_optim
from rec_pangu_tpu.train.fused_update import maybe_enable_fused_update as jax_enable_fused
from rec_pangu_tpu.train.steps import create_train_state
from rec_pangu_tpu_torch.convert import jax_tree, jax_variables, load_jax_variables
from rec_pangu_tpu_torch.data import get_dataloader
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.models.multi_task.common import TaskTower
from rec_pangu_tpu_torch.ops.dropout import mlp_stream
from rec_pangu_tpu_torch.ops.kernels.fused_encoder import dropout_scale
from rec_pangu_tpu_torch.train import RankTrainer
from rec_pangu_tpu_torch.train.fused_update import FusedStep, maybe_enable_fused_update

from conftest import MULTITASK_SCHEMA

FIELDS, VOCAB, DENSE, DIM, BATCH = 4, 50, 2, 8, 64
# the fused-step tests: the JAX fused step engages on tables of 64k rows up
STEP_VOCAB, STEP_BATCH = 16384, 2048
LR = 1e-3
HANDFUL = 16
# gradients 0 analytically: OMOE's expert bias reaches its towers through an
# input-independent gate, so a BatchNorm undoes it
ZERO_GRAD = {"OMOE": ("['experts_bias']",)}
TOWER = {"hidden_dim": (16, 8), "dropouts": (0.0, 0.0)}
EXPERTS = {"n_expert": 3, **TOWER}
CONFIGS = {"ShareBottom": {"hidden_units": (16, 8), "dropouts": (0.0, 0.0)},
           "ESSM": TOWER,
           "MMOE": {**EXPERTS, "mmoe_hidden_dim": 16},
           "OMOE": {**EXPERTS, "omoe_hidden_dim": 16},
           "MLMMOE": {**EXPERTS, "mmoe_hidden_dim": 16},
           "AITM": {"tower_dims": (16, 16, 16), "drop_prob": (0.0, 0.0, 0.0)}}
MODELS = tuple(CONFIGS)
CPU = torch.device("cpu")


def _enc_dict(vocab=VOCAB):
    enc = {f"s{f}": {"vocab_size": vocab} for f in range(FIELDS)}
    enc.update({f"d{d}": {"min": 0.0, "max": 1.0} for d in range(DENSE)})
    return enc


def _batch(seed, vocab=VOCAB, rows=BATCH):
    rng = np.random.default_rng(seed)
    return {"sparse": rng.integers(0, vocab + 1, (rows, FIELDS)).astype(np.int32),
            "dense": rng.random((rows, DENSE)).astype(np.float32),
            "label": rng.integers(0, 2, (rows, 2)).astype(np.float32)}


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _kwargs(name):
    return {"embedding_dim": DIM, **CONFIGS[name]}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _zero_grad(name, key, keys):
    """A leaf whose gradient is 0 analytically: a shift a later BatchNorm
    undoes.  A tower has no activation, so every bias before its last
    BatchNorm is one: Dense_i's bias where BatchNorm_i follows, and
    BatchNorm_i's where BatchNorm_{i+1} does; and ZERO_GRAD's."""
    if key in ZERO_GRAD.get(name, ()):
        return True
    if not key.endswith("['bias']"):
        return False
    for i in range(8):
        nxt = {f"['Dense_{i}']": f"['BatchNorm_{i}']",
               f"['BatchNorm_{i}']": f"['BatchNorm_{i + 1}']"}
        for part, after in nxt.items():
            if part in key and key.replace(part, after).replace("['bias']", "['scale']") in keys:
                return True
    return False


def _grad_tol(ref):
    return 1e-5 * max(float(np.abs(ref).max()), 1e-3)


@functools.lru_cache(maxsize=None)
def jax_model(name):
    """The JAX model and its variables (BatchNorm statistics moved away
    from their init)."""
    model = jax_get_model(name)(enc_dict=_enc_dict(), **_kwargs(name))
    jbatch = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    variables = _numpy(dict(model.init({"params": jax.random.PRNGKey(1),
                                        "dropout": jax.random.PRNGKey(2)}, jbatch, False)))
    if "batch_stats" in variables:
        rng = np.random.default_rng(3)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda v: v + rng.random(v.shape).astype(np.float32), variables["batch_stats"])
    return model, variables


def _port(name, variables, enc=None, **kwargs):
    model = get_model(name)(enc_dict=enc or _enc_dict(), **(kwargs or _kwargs(name)))
    load_jax_variables(model, variables)
    return model


def test_registry():
    for name in MODELS:
        assert get_model(name).__name__ == name
        assert get_model(name.lower()).__name__ == name


@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax_in_eval(name):
    jmodel, variables = jax_model(name)
    batch = _batch(1)
    want = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, False)
    model = _port(name, variables).eval()
    with torch.no_grad():
        got = model(model.upload_batch(batch, CPU))
    assert sorted(got) == ["task1_pred", "task2_pred"]
    for key in got:
        assert got[key].shape == (BATCH,)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5)
    # and back: the port's variables are the JAX model's
    back = jax_variables(model)
    for coll in ("params", "batch_stats"):
        want_leaves, got_leaves = _leaves(variables.get(coll)), _leaves(back[coll])
        assert got_leaves.keys() == want_leaves.keys()
        for key, arr in want_leaves.items():
            np.testing.assert_array_equal(got_leaves[key], arr, err_msg=key)


@pytest.mark.parametrize("name", MODELS)
def test_training_loss_and_gradients_match_jax(name):
    """Batch statistics in training (BatchNorm), the model's own loss."""
    jmodel, variables = jax_model(name)
    batch = _batch(4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(params):
        out, _ = jmodel.apply({**rest, "params": params}, jbatch, True,
                              mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(5)})
        return out["loss"]

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    model = _port(name, variables).train()
    out = model(model.upload_batch(batch, CPU, train=True), train=True, seed=1)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(want_loss), rtol=1e-5)
    got = _leaves(jax_tree(model, lambda t: t.grad))
    want = _leaves(_numpy(want_grads))
    assert got.keys() == want.keys()
    for key, ref in want.items():
        atol = 1e-6 if _zero_grad(name, key, want) else _grad_tol(ref)
        np.testing.assert_allclose(got[key], ref, rtol=0, atol=atol, err_msg=key)


@functools.lru_cache(maxsize=None)
def jax_fused_run(name):
    """Three JAX fused steps (K1 and K3 in interpret mode) from one seeded
    model: its variables before and after step 1, and the three losses."""
    enc = _enc_dict(STEP_VOCAB)
    batches = [_batch(s, STEP_VOCAB, STEP_BATCH) for s in (10, 11, 12)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
        mp.setenv("REC_PANGU_TPU_EMB_GRAD_PRECISION", "highest")
        model = jax_get_model(name)(enc_dict=enc, **_kwargs(name))
        state = create_train_state(model, batches[0], jax_optim.make_optimizer(LR, 1),
                                   jax.random.PRNGKey(0))
        planned = [attach_emb_plan(dict(b), model.spec, DIM) for b in batches]
        state, step, tables = jax_enable_fused(state, model, planned[0], LR, 1)
        assert step is not None, "the JAX fused step did not engage"

        def variables():
            return {"params": _numpy(state.params),
                    "batch_stats": None if state.batch_stats is None
                    else _numpy(state.batch_stats)}

        start = variables()
        losses, after_one = [], None
        with jax.default_matmul_precision("highest"):
            for b in planned:
                state, out = step(state, b, jax.random.PRNGKey(1))
                losses.append(float(out["loss"]))
                after_one = after_one or variables()
    return {"enc": enc, "start": start, "after_one": after_one, "losses": losses,
            "batches": batches, "tables": sorted("/".join(p) for p in tables)}


@pytest.mark.parametrize("name", MODELS)
def test_fused_steps_match_jax_fused_step(name):
    j = jax_fused_run(name)
    model = _port(name, {k: v for k, v in j["start"].items() if v is not None},
                  enc=j["enc"]).train()
    step = maybe_enable_fused_update(model, LR, 1)
    assert isinstance(step, FusedStep) and len(step.tables) == 1
    losses, after_one = [], None
    for i, batch in enumerate(j["batches"]):
        out = step(model.upload_batch(batch, CPU, train=True), i)
        losses.append(float(out["loss"].detach()))
        after_one = after_one or jax_variables(model)
    np.testing.assert_allclose(losses, j["losses"], rtol=1e-5)
    beyond = 0
    for coll in ("params", "batch_stats"):
        want = _leaves(j["after_one"][coll])
        got = _leaves(after_one[coll])
        assert got.keys() == want.keys()
        for key, arr in want.items():
            diff = np.abs(got[key] - arr)
            assert diff.max() <= 2 * LR, key
            if coll == "params" and _zero_grad(name, key, want):
                continue  # Adam's first step of a rounding: lr times its sign
            beyond += int((diff > 1e-6).sum())
    assert beyond <= HANDFUL
    assert sorted(step.opt_state(3)["tables"]) == j["tables"] == ["FusedEmbedding_0/table"]


def test_fused_step_refusal_restores_running_statistics():
    """A forward that looks the table up twice is refused before any
    weight, moment or running statistic changes."""
    _, variables = jax_model("MMOE")
    model = _port("MMOE", variables).train()
    step = maybe_enable_fused_update(model, LR, 1)
    forward = model.forward

    def twice(batch, train=False, capture=None, seed=None):
        model.embedding(batch["sparse"], capture)
        return forward(batch, train, capture, seed)

    model.forward = twice
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="exactly one lookup"):
        step(model.upload_batch(_batch(6), CPU, train=True), 0)
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_tower_dropout_draws_its_stream():
    """Task i's tower drops on MLP stream i with the step's seed, before
    its output layer; two towers of one model drop other elements."""
    gen = torch.Generator().manual_seed(0)
    towers = [TaskTower(12, (16, 8), (0.5, 0.5), gen, i) for i in range(2)]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((32, 12)).astype(np.float32))
    for i, tower in enumerate(towers):
        with torch.no_grad():
            got = tower(x, True, 11)
            h = x
            for j in range(2):
                h = torch.nn.functional.batch_norm(
                    tower.dense[j](h), None, None, tower.bn[j].weight, tower.bn[j].bias,
                    training=True, eps=tower.bn[j].eps)
                h = h * dropout_scale(11, 32, *mlp_stream(i, j), (h.shape[1],), 0.5)
            want = torch.sigmoid(tower.dense[2](h))[:, 0]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    a = dropout_scale(11, 32, *mlp_stream(0, 0), (16,), 0.5)
    b = dropout_scale(11, 32, *mlp_stream(1, 0), (16,), 0.5)
    assert not torch.equal(a, b)


def test_fit_evaluate_predict_on_multitask_sample(multitask_df, tmp_path):
    """``RankTrainer(num_task=2)`` on MULTITASK_SCHEMA: the fused step
    trains MMOE (loss down over the epochs), ``evaluate_model`` gives the
    per-task metrics, the predictions are [N, 2] probabilities, and
    ``predict_dataframe`` of the raw frame equals ``predict_dataloader``."""
    train_loader, valid_loader, test_loader, enc_dict = get_dataloader(
        multitask_df[:80], multitask_df[:90], multitask_df[:95], MULTITASK_SCHEMA,
        batch_size=16)
    model = get_model("MMOE")(enc_dict=enc_dict, embedding_dim=8, seed=3)
    trainer = RankTrainer(num_task=2, model_ckpt_dir=str(tmp_path), device="cpu")
    metrics = trainer.fit(model, train_loader, valid_loader, epoch=3, lr=1e-3,
                          use_earlystopping=True, max_patience=5,
                          monitor_metric="test_task1_roc_auc_score")
    assert trainer._train_step.fused
    assert set(metrics) == {f"train_task{t}_{m}" for t in (1, 2)
                            for m in ("roc_auc_score", "log_loss")}
    assert (tmp_path / "model_e_3.ckpt").exists() and (tmp_path / "model_best.ckpt").exists()
    test = trainer.evaluate_model(model, test_loader)
    assert set(test) == {f"test_task{t}_{m}" for t in (1, 2)
                         for m in ("roc_auc_score", "log_loss")}
    assert all(np.isfinite(v) for v in test.values())
    preds = trainer.predict_dataloader(model, test_loader)
    assert preds.shape == (95, 2) and ((preds >= 0) & (preds <= 1)).all()
    frame = trainer.predict_dataframe(model, multitask_df[:95], enc_dict, MULTITASK_SCHEMA,
                                      batch_size=16)
    np.testing.assert_array_equal(frame, preds)
