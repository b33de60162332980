"""GRU4Rec, YotubeDNN, NARM, STAMP and NextItNet served and trained by the
port against the JAX package's models, and their layers (the GRU, Caser's
convolutions, NextItNet's stack) against the flax modules.

Weights are made by the JAX package (small random biases and LayerNorm
scales, so that every term counts) and carried across; batches come from a
numpy seed, with histories of lengths 0, 1 and L and a mask that is not a
prefix.  Dropout is off in the comparisons with JAX.  Tolerances, float32
on both sides summed in other orders:

* layer outputs within atol 1e-5, their gradients within 1e-5 of each
  array's largest entry;
* ``user_emb`` within atol 1e-5 and the training loss within rtol 1e-5;
  the first step's gradients within 1e-5 of each leaf's largest entry (JAX
  at ``highest`` precision);
* three sequence fused steps against three JAX standard steps: the
  parameters after one step within atol 1e-6, the losses within rtol 1e-5;
  the port's standard step against its fused step within atol 1e-6;
* the retrieval scorer's scores within atol 1e-5 of JAX's and its ids
  equal on rows without near-ties; retrieval metrics on the bundled data
  (GRU4Rec) equal to the JAX trainer's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.ops.conv import NextItNetLayer as JaxNextItNetLayer
from rec_pangu_tpu.ops.sequence_enc import CaserEncoder as JaxCaserEncoder
from rec_pangu_tpu.ops.sequence_enc import GRU as JaxGRU
from rec_pangu_tpu.serving import make_retrieval_scorer as jax_make_retrieval_scorer
from rec_pangu_tpu.train import SequenceTrainer as JaxSequenceTrainer
from rec_pangu_tpu.train.ckpt import load_checkpoint as jax_load_checkpoint
from rec_pangu_tpu.train.ckpt import save_checkpoint as jax_save_checkpoint
from rec_pangu_tpu.train.optim import make_optimizer as jax_make_optimizer
from rec_pangu_tpu.train.steps import TrainState, make_train_step
from rec_pangu_tpu_torch.convert import jax_tree, jax_variables, load_jax_variables
from rec_pangu_tpu_torch.data import get_dataloader
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.ops.conv import NextItNetLayer
from rec_pangu_tpu_torch.ops.kernels.fused_encoder import dropout_scale
from rec_pangu_tpu_torch.ops.sequence_enc import (GRU, NARM_CT_DROPOUT, NARM_EMB_DROPOUT,
                                                  NEXTITNET_DROPOUT, STAMP_DROPOUT,
                                                  CaserEncoder, STAMPLayer, feature_dropout)
from rec_pangu_tpu_torch.serving import make_retrieval_scorer
from rec_pangu_tpu_torch.train import SequenceTrainer
from rec_pangu_tpu_torch.train import fused_update
from rec_pangu_tpu_torch.train.fused_update import SeqFusedStep, maybe_enable_seq_fused_update
from rec_pangu_tpu_torch.train.steps import StandardStep

from conftest import SEQ_SCHEMA

B, L, VOCAB, D, LR = 16, 12, 50, 16, 1e-3
ENC = {"item_id": {"vocab_size": VOCAB}}
BASE = {"embedding_dim": D, "max_length": L, "item_col": "item_id"}
# each model's JAX defaults, dropout off
CONFIGS = {"GRU4Rec": BASE, "YotubeDNN": BASE, "NARM": {**BASE, "dropout_probs": [0.0, 0.0]},
           "STAMP": BASE, "NextItNet": BASE}
MODELS = tuple(CONFIGS)
CPU = torch.device("cpu")
NOT_PREFIX = np.array([0, 1, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0], np.float32)  # row 3's mask


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _masks(rng, n=B):
    """Prefix masks of lengths 0..L (rows 0, 1, 2: 0, 1, L) and row 3 not a
    prefix."""
    lens = rng.integers(0, L + 1, n)
    lens[:3] = (0, 1, L)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    mask[3] = NOT_PREFIX
    return mask


def _batch(seed, train=False):
    rng = np.random.default_rng(seed)
    mask = _masks(rng)
    hist = np.where(mask > 0, rng.integers(1, VOCAB, (B, L)), 0).astype(np.int32)
    batch = {"hist_item_list": hist, "hist_mask_list": mask}
    if train:
        batch["target_item"] = rng.integers(1, VOCAB, B).astype(np.int32)
    return batch


def _noisy(params, seed):
    """Small random offsets on every bias and LayerNorm scale."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a + (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if jax.tree_util.keystr(p).endswith(("['bias']", "['scale']")) else a,
        _numpy(params))


def _grad_tol(ref):
    return 1e-5 * max(float(np.abs(ref).max()), 1e-3)


def _assert_tree_close(got, want, atol_of):
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(flat_want)
    for path, arr in flat_got:
        ref = np.asarray(flat_want[path])
        np.testing.assert_allclose(arr, ref, rtol=0, atol=atol_of(ref),
                                   err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------- layers
def _layer_grads(module, x, *args, **kwargs):
    """Gradients of sum(out * w) for a fixed w: the module's leaves and x."""
    x = torch.from_numpy(x).requires_grad_()
    out = module(x, *args, **kwargs)
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(out.shape).astype(np.float32))
    (out * w).sum().backward()
    return out.detach().numpy(), w.numpy(), x.grad.numpy(), jax_tree(module, lambda t: t.grad)


def _jax_layer_grads(apply, params, x, w):
    """(output, gradients of sum(out * w) as (params, x)) from one jit."""
    def f(p, x):
        out = apply(p, x)
        return jnp.sum(out * w), out

    with jax.default_matmul_precision("highest"):
        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            params, x)
    return np.asarray(out), _numpy(gp), np.asarray(gx)


@pytest.mark.parametrize("mask_kind", ["prefix_0_1_L", "not_prefix", "no_mask"])
def test_gru_matches_flax(mask_kind):
    """Two layers; with a mask, flax's carry at seq_lengths - 1 (modulo L:
    an empty history reads the carry after every step), without one the
    last step's; every output of the last layer."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = _masks(rng)
    if mask_kind == "prefix_0_1_L":
        mask[3] = 1.0
    jgru = JaxGRU(24, num_layers=2)
    jmask = None if mask_kind == "no_mask" else jnp.asarray(mask)
    params = _noisy(jgru.init(jax.random.PRNGKey(0), x, jmask)["params"], 2)
    want_out, want_last = jax.jit(lambda p, x: jgru.apply({"params": p}, x, jmask))(params, x)
    gru = GRU(D, 24, num_layers=2)
    load_jax_variables(gru, {"params": params})
    with torch.no_grad():
        out = gru(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=1e-5)
    lengths = torch.from_numpy(mask.sum(1) if jmask is not None else np.full(B, L, np.float32))
    last = GRU.last_carry(out, lengths.long())
    np.testing.assert_allclose(last.numpy(), want_last, rtol=0, atol=1e-5)
    if mask_kind == "prefix_0_1_L":  # the empty history reads the L-th carry, as the full one
        np.testing.assert_array_equal(last[0].numpy(), out[0, L - 1].numpy())
    # gradients through every output
    got, w, gx, gp = _layer_grads(gru, x)
    _, want_gp, want_gx = _jax_layer_grads(
        lambda p, x: jgru.apply({"params": p}, x, jmask)[0], params, x, w)
    np.testing.assert_allclose(gx, want_gx, rtol=0, atol=_grad_tol(want_gx))
    _assert_tree_close(gp, want_gp, _grad_tol)


@pytest.mark.parametrize("length", [L, 9])
def test_caser_matches_flax(length):
    """At max_his = L and on a shorter sequence (zero-padded to max_his)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, length, D)).astype(np.float32)
    lengths = jnp.full((B,), length)
    jcaser = JaxCaserEncoder(L, 16, 8, 5)
    params = _noisy(jcaser.init(jax.random.PRNGKey(0), x, lengths)["params"], 4)
    assert params["fc"]["kernel"].shape == (8 * D + 5 * 16, D)
    caser = CaserEncoder(L, D, 16, 8, 5)
    load_jax_variables(caser, {"params": params})
    got, w, gx, gp = _layer_grads(caser, x)
    want, want_gp, want_gx = _jax_layer_grads(
        lambda p, x: jcaser.apply({"params": p}, x, lengths), params, x, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gx, want_gx, rtol=0, atol=_grad_tol(want_gx))
    _assert_tree_close(gp, want_gp, _grad_tol)


def test_caser_tree_round_trips_through_convert():
    """``jax_variables`` then ``load_jax_variables`` of Caser's 4-D conv
    kernels: flax's own shapes ([kh, kw, in, out]) and values both ways,
    the JAX module serving the port's tree; a 4-D leaf marked transposed
    (reversed axes, [out, in, kw, kh]) is refused."""
    x = np.random.default_rng(12).standard_normal((B, L, D)).astype(np.float32)
    lengths = jnp.full((B,), L)
    jcaser = JaxCaserEncoder(L, 16, 8, 5)
    want_shapes = jax.tree_util.tree_map(
        np.shape, jcaser.init(jax.random.PRNGKey(0), x, lengths)["params"])
    caser = CaserEncoder(L, D, 16, 8, 5, generator=torch.Generator().manual_seed(1))
    tree = jax_variables(caser)
    assert tree["batch_stats"] is None
    assert jax.tree_util.tree_map(np.shape, tree["params"]) == want_shapes
    other = CaserEncoder(L, D, 16, 8, 5, generator=torch.Generator().manual_seed(2))
    load_jax_variables(other, tree)
    for (_, _, a, _), (_, _, b, _) in zip(caser.jax_leaves(), other.jax_leaves()):
        assert torch.equal(a, b)
    jax.tree_util.tree_map(np.testing.assert_array_equal, jax_variables(other)["params"],
                           tree["params"])
    want = jax.jit(lambda p, x: jcaser.apply({"params": p}, x, lengths))(tree["params"], x)
    with torch.no_grad():
        np.testing.assert_allclose(other(torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-5)

    class Transposed4D(torch.nn.Module):
        def jax_leaves(self):
            return [("params", ("conv_v", "kernel"), caser.conv_v_kernel, True)]

    with pytest.raises(ValueError, match="cannot be transposed"):
        jax_variables(Transposed4D())
    with pytest.raises(ValueError, match="cannot be transposed"):
        load_jax_variables(Transposed4D(), tree)


@pytest.mark.parametrize("one_masked", [False, True])
def test_nextitnet_layer_matches_flax(one_masked):
    """Both block kinds (ResBlockTwoMasked at dilations (1, 4),
    ResBlockOneMasked at (1, 2, 4)), read at clip(lens - 1)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    lens = _masks(rng).sum(1).astype(np.int32)
    jlayer = JaxNextItNetLayer(D, one_masked=one_masked)
    params = _noisy(jlayer.init(jax.random.PRNGKey(0), x, jnp.asarray(lens), False)["params"], 6)
    layer = NextItNetLayer(D, one_masked=one_masked)
    load_jax_variables(layer, {"params": params})
    got, w, gx, gp = _layer_grads(layer, x, torch.from_numpy(lens))
    want, want_gp, want_gx = _jax_layer_grads(
        lambda p, x: jlayer.apply({"params": p}, x, jnp.asarray(lens), False), params, x, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gx, want_gx, rtol=0, atol=_grad_tol(want_gx))
    _assert_tree_close(gp, want_gp, _grad_tol)


@pytest.mark.parametrize("layer", ["stamp", "nextitnet"])
def test_feature_dropout_is_the_hash_mask_of_its_stream(layer):
    """In training, STAMP's and NextItNet's feat_drop multiply the input by
    ``dropout_scale`` of their own stream for the step's seed: the layer
    in training equals the layer in eval fed the masked input."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))
    lens = torch.from_numpy(_masks(rng).sum(1).astype(np.int64))
    if layer == "stamp":
        module, stream = STAMPLayer(D, feat_drop=0.3), STAMP_DROPOUT
    else:
        module, stream = NextItNetLayer(D, feat_drop=0.3), NEXTITNET_DROPOUT
    scale = dropout_scale(11, B, *stream, (L, D), 0.3)
    assert 0.5 < float((scale > 0).float().mean()) < 0.9
    with torch.no_grad():
        got = module(x, lens, True, 11)
        want = module(x * scale, lens, False)
        other = module(x, lens, True, 12)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, other)


def test_dropout_streams_are_distinct():
    streams = (NARM_EMB_DROPOUT, NARM_CT_DROPOUT, STAMP_DROPOUT, NEXTITNET_DROPOUT)
    assert len({3 * layer + site for layer, site in streams}) == len(streams)
    x = torch.ones(B, L, D)
    masks = [feature_dropout(x, 0.5, 3, s) for s in streams]
    for i in range(len(masks)):
        for j in range(i):
            assert not torch.equal(masks[i], masks[j])


def test_narm_dropout_sites_draw_from_the_step_seed():
    model = get_model("NARM")(enc_dict=ENC, config={**BASE, "dropout_probs": [0.25, 0.5]})
    inputs = model.upload_batch(_batch(9, train=True), CPU, train=True)
    with torch.no_grad():
        a = model(inputs, train=True, seed=4)["loss"]
        b = model(inputs, train=True, seed=4)["loss"]
        c = model(inputs, train=True, seed=5)["loss"]
        model.dropout_probs = [0.0, 0.0]
        d = model(inputs, train=True, seed=4)["loss"]
    assert a == b and a != c and a != d


# --------------------------------------------------------------------- models
@pytest.fixture(scope="module")
def jax_models():
    """{name: (JAX model, numpy params, jitted serving apply)}."""
    out = {}
    for i, name in enumerate(MODELS):
        model = jax_get_model(name)(enc_dict=ENC, config=CONFIGS[name])
        rngs = {"params": jax.random.PRNGKey(i), "dropout": jax.random.PRNGKey(9)}
        variables = jax.jit(lambda r, b: model.init(r, b, False))(rngs, _batch(0))
        apply = jax.jit(lambda p, b, m=model: m.apply({"params": p}, b, False)["user_emb"])
        out[name] = (model, _noisy(variables["params"], 20 + i), apply)
    return out


def _port(name, params, config=None, enc=ENC):
    model = get_model(name)(enc_dict=enc, config=config or CONFIGS[name])
    load_jax_variables(model, {"params": params})
    return model


def _user_emb(model, batch):
    with torch.no_grad():
        return model.eval()(model.upload_batch(batch, CPU))["user_emb"].numpy()


def test_registry():
    for name in MODELS:
        assert get_model(name).__name__ == name
        assert get_model(name.lower()).__name__ == name


@pytest.mark.parametrize("name", MODELS)
def test_user_emb_matches_jax(name, jax_models):
    _, params, apply = jax_models[name]
    batch = _batch(1)
    want = np.asarray(apply(params, batch))
    got = _user_emb(_port(name, params), batch)
    assert got.shape == (B, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _jax_loss_and_grads(jmodel, params, batch):
    def loss(p):
        return jmodel.apply({"params": p}, batch, True,
                            rngs={"dropout": jax.random.PRNGKey(2)})["loss"]

    with jax.default_matmul_precision("highest"):
        value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), _numpy(grads)


@pytest.mark.parametrize("name", MODELS)
def test_training_loss_and_gradients_match_jax(name, jax_models):
    jmodel, params, _ = jax_models[name]
    batch = _batch(4, train=True)
    want_loss, want_grads = _jax_loss_and_grads(jmodel, params, batch)
    model = _port(name, params).train()
    out = model(model.upload_batch(batch, CPU, train=True), train=True, seed=1)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), want_loss, rtol=1e-5)
    _assert_tree_close(jax_tree(model, lambda t: t.grad), want_grads, _grad_tol)


@pytest.fixture(scope="module")
def jax_standard_runs(jax_models):
    """Three JAX standard steps from the same weights, for each model."""
    runs = {}
    batches = [_batch(s, train=True) for s in (10, 11, 12)]
    for name in MODELS:
        jmodel, params, _ = jax_models[name]
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
    return runs


def _run(model, step, batches):
    losses, after_one = [], None
    for i, batch in enumerate(batches):
        out = step(model.upload_batch(batch, CPU, train=True), i)
        losses.append(float(out["loss"].detach()))
        after_one = after_one or jax_variables(model)["params"]
    return losses, after_one


@pytest.mark.parametrize("name", MODELS)
def test_fused_steps_match_jax_standard_step(name, jax_models, jax_standard_runs, monkeypatch):
    """K3's ids are the histories; the dense item gradient is the CE's.
    YotubeDNN's only weight is the table: no dense Adam at all."""
    j = jax_standard_runs[name]
    model = _port(name, jax_models[name][1]).train()
    step = maybe_enable_seq_fused_update(model, LR, 1)
    assert isinstance(step, SeqFusedStep)
    assert (step.optimizer is None) == (name == "YotubeDNN")
    launches = []
    adam_update = fused_update.planned_adam_update

    def record(ids, rows, table, mu, nu, hyper, dense=None):
        launches.append((ids.clone(), rows.shape, dense.shape))
        return adam_update(ids, rows, table, mu, nu, hyper, dense)

    monkeypatch.setattr(fused_update, "planned_adam_update", record)
    losses, after_one = _run(model, step, j["batches"])
    ids, rows_shape, dense_shape = launches[0]
    np.testing.assert_array_equal(ids.numpy(), j["batches"][0]["hist_item_list"].reshape(-1))
    assert rows_shape == (B * L, D) and dense_shape == (VOCAB, D)
    _assert_tree_close(after_one, j["after_one"], lambda ref: 1e-6)
    np.testing.assert_allclose(losses, j["losses"], rtol=1e-5)
    state = step.opt_state(3)
    assert state["tables"]["item_emb/table"]["mu"].shape == (VOCAB, D)
    assert (state["params"]["mu"] is None) == (name == "YotubeDNN")


@pytest.mark.parametrize("name", MODELS)
def test_standard_step_matches_fused_step(name, jax_models, jax_standard_runs, monkeypatch):
    j = jax_standard_runs[name]
    params = jax_models[name][1]
    fused_model, std_model = _port(name, params).train(), _port(name, params).train()
    _, fused = _run(fused_model, maybe_enable_seq_fused_update(fused_model, LR, 1),
                    j["batches"][:1])
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ADAM", "0")
    assert maybe_enable_seq_fused_update(std_model, LR, 1) is None
    _, std = _run(std_model, StandardStep(std_model, LR, 1, generator=torch.Generator()),
                  j["batches"][:1])
    _assert_tree_close(std, fused, lambda ref: 1e-6)


@pytest.mark.parametrize("name", MODELS)
def test_checkpoints_round_trip_both_ways(name, jax_models, tmp_path):
    _, params, apply = jax_models[name]
    batch = _batch(5)
    want = np.asarray(apply(params, batch))
    path = str(tmp_path / "jax" / "model.ckpt")
    jax_save_checkpoint(path, params, None, enc_dict=ENC, step=3)
    model = get_model(name)(enc_dict=ENC, config=CONFIGS[name])
    trainer = SequenceTrainer(device="cpu")
    assert trainer.load_model(model, path)["enc_dict"] == ENC and trainer.step == 3
    np.testing.assert_allclose(_user_emb(model, batch), want, rtol=0, atol=1e-5)
    ckpt = jax_load_checkpoint(trainer.save_all(model, ENC, str(tmp_path / "port")))
    jax.tree_util.tree_map(np.testing.assert_array_equal, ckpt["params"], params)
    np.testing.assert_allclose(np.asarray(apply(ckpt["params"], batch)), _user_emb(model, batch),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_retrieval_scorer_matches_jax(name, jax_models):
    jmodel, params, _ = jax_models[name]
    batch = _batch(6)
    topk = 20
    want_s, want_i = (np.asarray(a) for a in jax_make_retrieval_scorer(
        jmodel, {"params": params}, topk=topk + 1)(batch))
    got_s, got_i = make_retrieval_scorer(_port(name, params), topk=topk, device="cpu")(batch)
    assert got_s.shape == got_i.shape == (B, topk) and got_i.dtype == np.int32
    np.testing.assert_allclose(got_s, want_s[:, :topk], rtol=0, atol=1e-5)
    # rows whose neighbouring JAX scores (one past the top-k included) lie
    # further apart than the tolerance
    tie_free = (-np.diff(want_s, axis=1) > 2e-5).all(axis=1)
    assert tie_free.sum() >= 1
    np.testing.assert_array_equal(got_i[tie_free], want_i[tie_free, :topk])


def test_evaluate_model_matches_jax_on_bundled_data_gru4rec(seq_dfs, tmp_path):
    schema = {**SEQ_SCHEMA, "max_length": 20}
    config = {"embedding_dim": 16, "max_length": 20}
    loaders = get_dataloader(*seq_dfs, schema, batch_size=1024)
    enc = loaders[3]
    jmodel = jax_get_model("GRU4Rec")(enc_dict=enc, config=config)
    sample = {k: v for k, v in next(iter(loaders[2])).items() if k.startswith("hist_")}
    rngs = {"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)}
    params = jax.jit(lambda r, b: jmodel.init(r, b, False))(rngs, sample)["params"]
    jtrainer = JaxSequenceTrainer(model_ckpt_dir=str(tmp_path))
    tx = jax_make_optimizer(1e-3, 1)
    jtrainer.state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=None,
                                opt_state=tx.init(params), apply_fn=jmodel.apply, tx=tx)
    jtrainer.model, jtrainer._has_bs = jmodel, False
    model = _port("GRU4Rec", _numpy(params), config, enc)
    want = jtrainer.evaluate_model(jmodel, loaders[2])
    got = SequenceTrainer(device="cpu").evaluate_model(model, loaders[2])
    assert list(got) == [f"{m}@{k}" for k in (20, 50, 100) for m in ("recall", "ndcg", "hitrate")]
    assert got == want
