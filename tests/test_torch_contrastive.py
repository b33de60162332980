"""CLRec and ContraRec served and trained by the port against the JAX
package's models; ContraRec with each of its encoders (BERT4Rec, GRU4Rec,
Caser: the cases ``ContraRec-<encoder>`` of ``MODELS``).

Weights are made by the JAX package (with small random biases, so that
every term counts) and carried across; batches come from a numpy seed, with
histories of every length from 0 to L.  Tolerances, float32 on both sides
summed in other orders:

* ``safe_l2norm`` and both contrastive losses within rtol 1e-6;
* ``user_emb`` [B, D] within atol 1e-5 of the JAX model's, on its flax
  encoder and on its Pallas encoder in interpret mode;
* the training loss within rtol 1e-5 and every gradient within 1e-5 of its
  leaf's largest entry (JAX at ``highest`` precision); the key projections'
  biases have an exact gradient of 0 (a softmax does not change when a row
  of scores moves by one constant), so both sides hold rounding noise
  there, held within 1e-5 of 0;
* three sequence fused steps against three JAX standard steps: the
  parameters after one step within atol 1e-6 (those zero gradients, which
  Adam's first step turns into +-lr, within 2 lr), the losses within rtol
  1e-5.  The GRU4Rec and Caser encoders leave gradients near Adam's eps
  (1e-8), where its first step, lr g / (|g| + eps), turns rounding into
  moves of up to 2 lr: their parameters after one step are held within
  1e-6 plus the most Adam's first step can move apart for two gradients
  within the gradient gate (1e-5 of the leaf's largest entry) of JAX's
  (``_adam_move_bound``);
* retrieval metrics on the bundled data equal to the JAX trainer's.
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.models.sequence.contra_losses import (
    clrec_contra_loss as jax_clrec_contra_loss,
    contrarec_contra_loss as jax_contrarec_contra_loss)
from rec_pangu_tpu.ops.numerics import safe_l2norm as jax_safe_l2norm
from rec_pangu_tpu.train import SequenceTrainer as JaxSequenceTrainer
from rec_pangu_tpu.train.ckpt import load_checkpoint as jax_load_checkpoint
from rec_pangu_tpu.train.optim import make_optimizer as jax_make_optimizer
from rec_pangu_tpu.train.steps import TrainState, make_train_step
from rec_pangu_tpu_torch.convert import jax_tree, jax_variables, load_jax_variables
from rec_pangu_tpu_torch.data import get_dataloader
from rec_pangu_tpu_torch.models import SequenceModelBase, get_model
from rec_pangu_tpu_torch.models.sequence.augment import (augment_sequences,
                                                          host_augment_sequences)
from rec_pangu_tpu_torch.models.sequence.contra_losses import (clrec_contra_loss,
                                                                contrarec_contra_loss)
from rec_pangu_tpu_torch.ops.numerics import safe_l2norm
from rec_pangu_tpu_torch.serving import make_retrieval_scorer
from rec_pangu_tpu_torch.train import SequenceTrainer
from rec_pangu_tpu_torch.train import fused_update
from rec_pangu_tpu_torch.train.fused_update import SeqFusedStep, maybe_enable_seq_fused_update

from conftest import SEQ_SCHEMA

B, L, VOCAB, D, LR = 16, 12, 300, 16, 1e-3
CONFIG = {"embedding_dim": D, "max_length": L, "item_col": "item_id"}
ENC = {"item_id": {"vocab_size": VOCAB}}
MODELS = ("CLRec", "ContraRec", "ContraRec-GRU4Rec", "ContraRec-Caser")
ZERO_GRAD = ("['key']['bias']",)  # exact gradients of 0
CPU = torch.device("cpu")


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _model(case):
    """The model name of a case of MODELS."""
    return case.split("-")[0]


def _config(case, base=CONFIG):
    """``base`` with the case's ContraRec encoder, if it names one."""
    _, *encoder = case.split("-")
    return {**base, "encoder_name": encoder[0]} if encoder else base


def _bert4rec(case):
    return _config(case).get("encoder_name", "BERT4Rec") == "BERT4Rec"


def _batch(seed, name=None):
    """Histories of lengths 0..L; with ``name``, a training batch with the
    host keys that model's trainer attaches (``lookup_all`` for CLRec,
    ``aug_all`` for ContraRec)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, B)
    lens[0] = 0
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    hist = np.where(mask > 0, rng.integers(1, VOCAB, (B, L)), 0).astype(np.int32)
    batch = {"hist_item_list": hist, "hist_mask_list": mask}
    if name is None:
        return batch
    batch["target_item"] = rng.integers(1, VOCAB, B).astype(np.int32)
    batch["target_item"][:3] = batch["target_item"][3]  # shared targets: positives
    if name == "CLRec":
        batch["lookup_all"] = np.concatenate([hist, batch["target_item"][:, None]], axis=1)
    else:
        views = [host_augment_sequences(rng, hist, 3.0, 3.0, VOCAB - 1) for _ in range(2)]
        batch["aug_all"] = np.concatenate([hist] + views)
    return batch


def _without(batch, key):
    return {k: v for k, v in batch.items() if k != key}


@pytest.fixture(scope="module")
def jax_models():
    """{name: (JAX model, numpy params)} with small random biases."""
    out = {}
    for i, name in enumerate(MODELS):
        model = jax_get_model(_model(name))(enc_dict=ENC, config=_config(name))
        rngs = {"params": jax.random.PRNGKey(i), "dropout": jax.random.PRNGKey(9)}
        variables = jax.jit(lambda r, b: model.init(r, b, False))(rngs, _batch(0))
        rng = np.random.default_rng(5 + i)
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: a + (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
            if jax.tree_util.keystr(p).endswith("['bias']") else a,
            _numpy(variables["params"]))
        out[name] = (model, params)
    return out


def _port(name, params, config=None, enc=ENC):
    model = get_model(_model(name))(enc_dict=enc, config=config or _config(name))
    load_jax_variables(model, {"params": params})
    return model


def _user_emb(model, batch):
    with torch.no_grad():
        return model.eval()(model.upload_batch(batch, CPU))["user_emb"].numpy()


def test_safe_l2norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 3, 8)).astype(np.float32)
    x[2, 1] = 0.0  # a zero row stays zero, with a finite gradient
    for axis in (-1, 1):
        want = np.asarray(jax_safe_l2norm(jnp.asarray(x), axis=axis))
        t = torch.from_numpy(x).requires_grad_()
        got = safe_l2norm(t, dim=axis)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)
        got.sum().backward()
        assert torch.isfinite(t.grad).all()
    assert not safe_l2norm(torch.from_numpy(x))[2, 1].any()


@pytest.mark.parametrize("labels", ["none", "shared_targets"])
def test_contrastive_losses_match_jax(labels):
    rng = np.random.default_rng(2)
    f2 = np.asarray(jax_safe_l2norm(jnp.asarray(rng.standard_normal((12, 2, 8)),
                                                jnp.float32)))
    item = rng.integers(1, 5, 12).astype(np.int32)  # many rows share a target
    want = float(jax_clrec_contra_loss(jnp.asarray(f2), 0.1))
    got = float(clrec_contra_loss(torch.from_numpy(f2), 0.1))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    lab = None if labels == "none" else item
    want = float(jax_contrarec_contra_loss(jnp.asarray(f2), None if lab is None
                                           else jnp.asarray(lab), 0.2))
    got = float(contrarec_contra_loss(torch.from_numpy(f2), None if lab is None
                                      else torch.from_numpy(lab), 0.2))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("path", ["flax", "pallas_interpret"])
@pytest.mark.parametrize("name", MODELS)
def test_user_emb_matches_jax(name, path, jax_models, monkeypatch):
    if path == "flax":
        monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    else:
        monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "1")
    model, params = jax_models[name]
    batch = _batch(1)
    want = np.asarray(jax.jit(lambda p, b: model.apply({"params": p}, b, False))(
        params, batch)["user_emb"])
    got = _user_emb(_port(name, params), batch)
    assert got.shape == (B, D)
    if _bert4rec(name):  # a history of length 0: a zero row (the GRU reads its L-th carry)
        assert not got[0].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _assert_tree_close(got, want, atol_of, zero_atol=None):
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(flat_want)
    for path, arr in flat_got:
        name = jax.tree_util.keystr(path)
        ref = np.asarray(flat_want[path])
        if any(k in name for k in ZERO_GRAD):
            if zero_atol is None:  # an exact gradient of 0: noise on both sides
                assert max(np.abs(arr).max(), np.abs(ref).max()) < 1e-5, name
            else:
                np.testing.assert_allclose(arr, ref, rtol=0, atol=zero_atol, err_msg=name)
            continue
        np.testing.assert_allclose(arr, ref, rtol=0, atol=atol_of(ref), err_msg=name)


def _grad_tol(ref):
    return 1e-5 * max(float(np.abs(ref).max()), 1e-3)


def _adam_move_bound(g):
    """Per entry of a JAX gradient g: 1e-6 plus the most Adam's first step
    (lr g / (|g| + eps)) moves apart for a gradient within ``_grad_tol``."""
    g = np.asarray(g, np.float64)
    tau = _grad_tol(g)

    def move(x):
        return x / (np.abs(x) + 1e-8)

    return 1e-6 + LR * np.maximum(np.abs(move(g + tau) - move(g)),
                                  np.abs(move(g - tau) - move(g)))


def _jax_loss_and_grads(jmodel, params, batch):
    def loss(p):
        return jmodel.apply({"params": p}, batch, True,
                            rngs={"dropout": jax.random.PRNGKey(2)})["loss"]

    with jax.default_matmul_precision("highest"):
        value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), _numpy(grads)


def _port_loss_and_grads(model, batch, seed=1):
    model.train().zero_grad(set_to_none=True)
    out = model(model.upload_batch(batch, CPU, train=True), train=True, seed=seed)
    out["loss"].backward()
    return float(out["loss"].detach()), jax_tree(model, lambda t: t.grad)


@pytest.mark.parametrize("name,drop", [("CLRec", None), ("CLRec", "lookup_all"),
                                       ("ContraRec", None), ("ContraRec-GRU4Rec", None),
                                       ("ContraRec-Caser", None)])
def test_training_loss_and_gradients_match_jax(name, drop, jax_models, monkeypatch):
    """CLRec with its joint [B, L + 1] lookup and with the two lookups of a
    batch without it; ContraRec with the host views, on each encoder."""
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    jmodel, params = jax_models[name]
    batch = _batch(4, name)
    if drop:
        batch = _without(batch, drop)
    want_loss, want_grads = _jax_loss_and_grads(jmodel, params, batch)
    loss, grads = _port_loss_and_grads(_port(name, params), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _assert_tree_close(grads, want_grads, _grad_tol)


@pytest.mark.parametrize("name", MODELS[1:])
def test_contrarec_device_views_match_jax_fed_the_same_views(name, jax_models, monkeypatch):
    """A training batch without ``aug_all``: the port draws its two views on
    the device from the step's seed (+2) and looks up [hist; v1; v2] at
    once, K7's call site.  JAX, fed those views as ``aug_all``, gives the
    same loss and gradients; so does the port fed them.  Each encoder."""
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    jmodel, params = jax_models[name]
    model = _port(name, params)
    batch = _without(_batch(5, name), "aug_all")
    seed = 7
    loss, grads = _port_loss_and_grads(model, batch, seed)
    gen = torch.Generator().manual_seed(seed + 2)
    hist = torch.from_numpy(batch["hist_item_list"])
    views = [augment_sequences(gen, hist, model.beta_a, model.beta_b, model.mask_token)
             for _ in range(2)]
    assert not all(torch.equal(v, hist) for v in views)
    fed = {**batch, "aug_all": torch.cat([hist] + views).numpy()}
    want_loss, want_grads = _jax_loss_and_grads(jmodel, params, fed)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _assert_tree_close(grads, want_grads, _grad_tol)
    fed_loss, fed_grads = _port_loss_and_grads(model, fed, seed)
    assert fed_loss == loss
    jax.tree_util.tree_map(np.testing.assert_array_equal, fed_grads, grads)
    other, _ = _port_loss_and_grads(model, batch, seed + 1)  # other views
    assert other != loss


@pytest.mark.parametrize("name", MODELS)
def test_trainer_host_keys_match_jax(name, jax_models):
    """CLRec's ``lookup_all`` and ContraRec's ``aug_all`` from the port's
    trainer equal the JAX trainer's ``_attach_plan`` on the same batches."""
    jmodel, params = jax_models[name]
    jtrainer = JaxSequenceTrainer()
    jtrainer.model = jmodel
    trainer = SequenceTrainer(device="cpu")
    trainer.model = _port(name, params)
    key = "lookup_all" if name == "CLRec" else "aug_all"
    for seed in (6, 7):
        batch = _without(_batch(seed, name), key)
        want = jtrainer._attach_plan(dict(batch))[key]
        got = trainer._attach_host_keys(batch)
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want)
        other = "aug_all" if name == "CLRec" else "lookup_all"
        assert other not in got
    if name == "CLRec":  # a batch without its extras gets no lookup_all
        assert "lookup_all" not in trainer._attach_host_keys(_without(batch, "target_item"))


@pytest.fixture(scope="module")
def jax_standard_runs(jax_models):
    """Three JAX standard steps (flax encoder) from the same weights, for
    each model, on batches with the model's host keys."""
    os.environ["REC_PANGU_TPU_FUSED_ENCODER"] = "0"
    runs = {}
    try:
        for name in MODELS:
            jmodel, params = jax_models[name]
            batches = [_batch(s, name) for s in (10, 11, 12)]
            tx = jax_make_optimizer(LR, 1)
            start = jax.tree_util.tree_map(jnp.asarray, params)
            state = TrainState(step=jnp.zeros((), jnp.int32), params=start, batch_stats=None,
                               opt_state=tx.init(start), apply_fn=jmodel.apply, tx=tx)
            step = make_train_step(False)
            losses, after_one = [], None
            for b in batches:
                state, out = step(state, b, jax.random.PRNGKey(1))
                losses.append(float(out["loss"]))
                after_one = after_one or _numpy(state.params)
            runs[name] = {"after_one": after_one, "losses": losses, "batches": batches}
            if not _bert4rec(name):  # the first step's gradients, for _adam_move_bound
                runs[name]["grads"] = _jax_loss_and_grads(jmodel, params, batches[0])[1]
    finally:
        del os.environ["REC_PANGU_TPU_FUSED_ENCODER"]
    return runs


@pytest.mark.parametrize("name", MODELS)
def test_fused_steps_match_jax_standard_step(name, jax_models, jax_standard_runs,
                                             monkeypatch):
    j = jax_standard_runs[name]
    model = _port(name, jax_models[name][1]).train()
    step = maybe_enable_seq_fused_update(model, LR, 1)
    assert isinstance(step, SeqFusedStep)
    launches = []
    adam_update = fused_update.planned_adam_update

    def record(ids, rows, table, mu, nu, hyper, dense=None):
        launches.append((ids.clone(), rows.shape, dense.shape))
        return adam_update(ids, rows, table, mu, nu, hyper, dense)

    monkeypatch.setattr(fused_update, "planned_adam_update", record)
    losses, after_one = [], None
    for i, batch in enumerate(j["batches"]):
        out = step(model.upload_batch(batch, CPU, train=True), i)
        losses.append(float(out["loss"].detach()))
        after_one = after_one or jax_variables(model)["params"]
    # K3's ids are the one lookup's: [hist | target] or [hist; v1; v2]
    key = model.fused_lookup_key
    ids, rows_shape, dense_shape = launches[0]
    np.testing.assert_array_equal(ids.numpy(), j["batches"][0][key].reshape(-1))
    assert rows_shape == (j["batches"][0][key].size, D) and dense_shape == (VOCAB, D)
    if _bert4rec(name):
        _assert_tree_close(after_one, j["after_one"], lambda ref: 1e-6, zero_atol=2 * LR)
    else:
        bounds = dict(jax.tree_util.tree_leaves_with_path(j["grads"]))
        want = dict(jax.tree_util.tree_leaves_with_path(j["after_one"]))
        for path, arr in jax.tree_util.tree_leaves_with_path(after_one):
            diff = np.abs(arr - want[path])
            assert (diff <= _adam_move_bound(bounds[path])).all(), (
                jax.tree_util.keystr(path), float(diff.max()))
    np.testing.assert_allclose(losses, j["losses"], rtol=1e-5)


def _state(model, step):
    """Every piece of state a step may change, copied."""
    opt = step.optimizer
    return {"params": {k: p.detach().clone() for k, p in model.named_parameters()},
            "grads": {k: None if p.grad is None else p.grad.clone()
                      for k, p in model.named_parameters()},
            "mu": step.mu.clone(), "nu": step.nu.clone(),
            "lr": [g["lr"] for g in opt.param_groups],
            "opt": {i: {k: v.clone() for k, v in s.items()}
                    for i, s in enumerate(opt.state.values())}}


def _assert_same_state(a, b):
    assert a["lr"] == b["lr"]
    for k in ("params", "grads"):
        for name, t in a[k].items():
            assert (t is None) == (b[k][name] is None), name
            assert t is None or torch.equal(t, b[k][name]), name
    assert torch.equal(a["mu"], b["mu"]) and torch.equal(a["nu"], b["nu"])
    assert a["opt"].keys() == b["opt"].keys()
    for i, s in a["opt"].items():
        assert all(torch.equal(v, b["opt"][i][k]) for k, v in s.items())


@pytest.mark.parametrize("fault", ["clrec_no_lookup_all", "contrarec_no_aug_all",
                                   "two_lookups", "no_ce"])
def test_fused_step_refuses_before_any_state_changes(fault, jax_models, monkeypatch):
    """A batch without the model's ``fused_lookup_key``, a forward that looks
    the table up twice, or a loss that skips the captured CE: ValueError,
    and every parameter, gradient, moment and optimizer state bit-equal."""
    name = "ContraRec" if fault == "contrarec_no_aug_all" else "CLRec"
    model = _port(name, jax_models[name][1]).train()
    step = maybe_enable_seq_fused_update(model, LR, 1)
    batch = _batch(20, name)
    step(model.upload_batch(batch, CPU, train=True), 0)  # a state to keep
    if fault == "clrec_no_lookup_all":
        batch, match = _without(batch, "lookup_all"), "lookup_all"
    elif fault == "contrarec_no_aug_all":
        batch, match = _without(batch, "aug_all"), "aug_all"
    elif fault == "two_lookups":  # ids read from the histories: hist and target lookups
        monkeypatch.setattr(model, "fused_lookup_key", "hist_item_list", raising=False)
        batch, match = _without(batch, "lookup_all"), "exactly one lookup"
    else:
        def no_capture(user_emb, pos_item, capture=None, seed=None):
            return SequenceModelBase.calculate_loss(model, user_emb, pos_item, None, seed)

        monkeypatch.setattr(model, "calculate_loss", no_capture)
        match = "exactly one captured softmax CE"
    before = _state(model, step)
    with pytest.raises(ValueError, match=match):
        step(model.upload_batch(batch, CPU, train=True), 1)
    _assert_same_state(before, _state(model, step))


def test_registry_and_encoders_not_ported():
    """Every encoder of the JAX package's ContraRec is ported (their parity
    cases are in MODELS); a name that is no ContraRec encoder raises."""
    assert get_model("CLRec").__name__ == "CLRec"
    assert get_model("contrarec").__name__ == "ContraRec"
    for enc, cls in (("BERT4Rec", "BERT4RecEncoder"), ("GRU4Rec", "GRU4RecEncoder"),
                     ("Caser", "CaserEncoder")):
        model = get_model("ContraRec")(enc_dict=ENC, config={**CONFIG, "encoder_name": enc})
        assert type(model.encoder).__name__ == cls
    with pytest.raises(ValueError, match="Invalid sequence encoder"):
        get_model("ContraRec")(enc_dict=ENC, config={**CONFIG, "encoder_name": "SASRec"})


@pytest.mark.parametrize("name", MODELS)
def test_scorer_serves_the_user_embeddings(name, jax_models):
    model = _port(name, jax_models[name][1])
    batch = _batch(13)
    scores, ids = make_retrieval_scorer(model, topk=20, device="cpu")(batch)
    assert scores.shape == ids.shape == (B, 20)
    assert np.all(np.isfinite(scores)) and np.all(np.diff(scores, axis=1) <= 0)


def _bundled(seq_dfs, name, batch_size=64):
    schema = {**SEQ_SCHEMA, "max_length": 20}
    loaders = get_dataloader(*seq_dfs, schema, batch_size=batch_size)
    return loaders, _config(name, {"embedding_dim": 16, "max_length": 20})


@pytest.mark.parametrize("name", MODELS)
def test_evaluate_model_matches_jax_on_bundled_data(name, seq_dfs, tmp_path, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    loaders, config = _bundled(seq_dfs, name, batch_size=1024)
    enc = loaders[3]
    jmodel = jax_get_model(_model(name))(enc_dict=enc, config=config)
    sample = {k: v for k, v in next(iter(loaders[2])).items() if k.startswith("hist_")}
    jtrainer = JaxSequenceTrainer(model_ckpt_dir=str(tmp_path))
    rngs = {"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)}
    params = jax.jit(lambda r, b: jmodel.init(r, b, False))(rngs, sample)["params"]
    tx = jax_make_optimizer(1e-3, 1)
    jtrainer.state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=None,
                                opt_state=tx.init(params), apply_fn=jmodel.apply, tx=tx)
    jtrainer.model, jtrainer._has_bs = jmodel, False
    model = _port(name, _numpy(jtrainer.state.params), config, enc)
    want = jtrainer.evaluate_model(jmodel, loaders[2])
    got = SequenceTrainer(device="cpu").evaluate_model(model, loaders[2])
    assert list(got) == [f"{m}@{k}" for k in (20, 50, 100) for m in ("recall", "ndcg", "hitrate")]
    assert got == want


@pytest.mark.parametrize("name", MODELS)
def test_fit_on_bundled_data_and_checkpoints(name, seq_dfs, tmp_path):
    loaders, config = _bundled(seq_dfs, name, batch_size=64)
    enc = loaders[3]
    model = get_model(_model(name))(enc_dict=enc, config=config)
    ckpt_dir = str(tmp_path / "ckpt")
    trainer = SequenceTrainer(model_ckpt_dir=ckpt_dir, device="cpu")
    losses, keys = [], set()
    step, upload = trainer._step, model.upload_batch

    def record(batch):
        out = step(batch)
        losses.append(float(out["loss"].detach()))
        return out

    def recording_upload(batch, device, train=False):  # what the hooks attached
        keys.update(batch if train else ())
        return upload(batch, device, train)

    trainer._step, model.upload_batch = record, recording_upload
    epochs, per_epoch = 3, len(loaders[0])
    trainer.fit(model, loaders[0], loaders[1], epoch=epochs, lr=5e-3, use_earlystopping=True,
                max_patience=epochs, monitor_metric="recall@20", seed=3)
    assert isinstance(trainer._train_step, SeqFusedStep)
    assert model.fused_lookup_key in keys
    assert trainer.step == len(losses) == epochs * per_epoch
    means = [np.mean(losses[i * per_epoch:(i + 1) * per_epoch]) for i in range(epochs)]
    assert np.all(np.isfinite(losses)) and means[-1] < means[0]
    with open(os.path.join(ckpt_dir, "log.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["1", "2", "3"] and "recall@20" in rows[0]
    assert {"model_e_1.ckpt", "model_e_3.ckpt", "model_best.ckpt"} <= set(os.listdir(ckpt_dir))

    # the checkpoint round trip: the JAX package reads it and serves the same users
    path = os.path.join(ckpt_dir, "model_e_3.ckpt")
    ckpt = jax_load_checkpoint(path)
    jax.tree_util.tree_map(np.testing.assert_array_equal, ckpt["params"],
                           jax_variables(model)["params"])
    batch = {k: v for k, v in next(iter(loaders[2])).items() if k.startswith("hist_")}
    want = _user_emb(model, batch)
    reloaded = get_model(_model(name))(enc_dict=enc, config=config)
    SequenceTrainer(device="cpu").load_model(reloaded, path)
    np.testing.assert_array_equal(_user_emb(reloaded, batch), want)
    os.environ["REC_PANGU_TPU_FUSED_ENCODER"] = "0"
    try:
        jmodel = jax_get_model(_model(name))(enc_dict=enc, config=config)
        jax_emb = np.asarray(jax.jit(lambda p, b: jmodel.apply({"params": p}, b, False))(
            ckpt["params"], batch)["user_emb"])
    finally:
        del os.environ["REC_PANGU_TPU_FUSED_ENCODER"]
    np.testing.assert_allclose(want, jax_emb, rtol=0, atol=1e-5)
