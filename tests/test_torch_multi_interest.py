"""The multi-interest family (ComirecSA, ComirecDR, MIND, SINE, Re4, CMI),
its layers and the trainer's host negatives and row projection in the port
against the JAX package.

Histories come from a numpy seed, with lengths 0, 1 and L; weights are made
by the JAX package (small random biases and LayerNorm terms) and carried
across by ``convert.py``.  MIND starts routing from the logits the JAX
package draws without a routing key, ``normal(PRNGKey(0), (B, K, L))``,
handed to the port as ``routing_logits``.  Tolerances:

* the layers (the self-attention and the capsule network of bilinear types
  0, 1 and 2): outputs within atol 1e-5, gradients within 1e-5 of each
  array's largest entry;
* ``user_emb`` in eval within atol 1e-5; the training loss within rtol 1e-5
  and the gradients within 1e-5 of each leaf's largest entry, against JAX
  at ``highest`` precision (CMI at an even and an odd batch: the
  interests' contrastive term only at an even one).  Re4's gradients are
  held against JAX's in float64: the port computes the re-contrast loss in
  log space, and JAX's float32 gradient of its ratio of exponentials loses
  terms to underflow on these inputs;
* three sequence fused steps against three JAX standard steps (MIND aside:
  the JAX step draws its routing logits from the step's key; Re4's in
  float64): the parameters after one step within atol 1e-6, within 2 lr
  where the first gradient is rounding noise, the losses within rtol 1e-5;
  ComirecSA's standard step against its fused step as the JAX package holds
  its own (the loss within rtol 1e-6, the parameters within atol 5e-6);
* CMI's ``neg_items`` and ``lookup_all`` from the trainer bit-equal to the
  JAX trainer's (a training batch without ``lookup_all`` raises); the
  projection at ``fit``'s start and after each step within atol 1e-6 of
  the JAX ``make_param_renorm`` of the same weights; its dropout's hash
  masks exact;
* ``fit`` on the bundled data (ComirecSA, CMI) runs the fused step, writes
  ``log.csv`` and checkpoints, and the reloaded model retrieves the same
  items; ComirecSA's ``evaluate_model`` equals the JAX trainer's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.ops import multi_interest as jax_mi
from rec_pangu_tpu.train import SequenceTrainer as JaxSequenceTrainer
from rec_pangu_tpu.train.optim import make_optimizer as jax_make_optimizer
from rec_pangu_tpu.train.steps import TrainState, make_train_step
from rec_pangu_tpu.train.steps import make_param_renorm as jax_make_param_renorm
from rec_pangu_tpu_torch.convert import jax_tree, jax_variables, load_jax_variables
from rec_pangu_tpu_torch.data import get_dataloader
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.models.sequence import cmi as cmi_module
from rec_pangu_tpu_torch.ops import multi_interest
from rec_pangu_tpu_torch.ops.sequence_enc import CMI_EMB_DROPOUT, feature_dropout
from rec_pangu_tpu_torch.serving import make_retrieval_scorer
from rec_pangu_tpu_torch.train import SequenceTrainer
from rec_pangu_tpu_torch.train import fused_update
from rec_pangu_tpu_torch.train import trainer as trainer_module
from rec_pangu_tpu_torch.train.fused_update import SeqFusedStep, maybe_enable_seq_fused_update
from rec_pangu_tpu_torch.train.steps import StandardStep, make_param_renorm

from conftest import SEQ_SCHEMA

B, L, VOCAB, D, K, LR = 8, 12, 500, 16, 4, 1e-3
ENC = {"item_id": {"vocab_size": VOCAB}}
BASE = {"embedding_dim": D, "max_length": L, "item_col": "item_id"}
CONFIGS = {"ComirecSA": {**BASE, "K": K}, "ComirecDR": {**BASE, "K": K},
           "MIND": {**BASE, "K": K},
           "SINE": {**BASE, "prototype_size": 20, "interest_size": K},
           "Re4": {**BASE, "K": K},
           "CMI": {**BASE, "K": 8, "num_layers": 2, "temp": 0.1, "w_clloss": 0.05,
                   "dropout_prob": 0.0}}
MODELS = tuple(CONFIGS)
STEP_MODELS = tuple(m for m in MODELS if m != "MIND")  # the JAX step keys MIND's routing
CPU = torch.device("cpu")


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _routing_logits(n=B, k=K):
    """The logits JAX's capsule network draws without a routing key."""
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (n, k, L)))


def _batch(seed, train=False, n=B):
    """Histories of lengths 0, 1, L in rows 0-2, the rest random; padded
    positions hold 0.  A training batch also has targets, two shared."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, n)
    lens[:3] = (0, 1, L)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    hist = np.where(mask > 0, rng.integers(1, VOCAB, (n, L)), 0).astype(np.int32)
    batch = {"hist_item_list": hist, "hist_mask_list": mask}
    if train:
        batch["target_item"] = rng.integers(1, VOCAB, n).astype(np.int32)
        batch["target_item"][4] = batch["target_item"][5]
    return batch


def _train_batch(name, seed, n=B, trainer=None):
    """A training batch with the host keys the port's trainer attaches
    (CMI: ``neg_items`` and ``lookup_all``)."""
    batch = _batch(seed, True, n)
    if name != "CMI":
        return batch
    if trainer is None:
        trainer = SequenceTrainer(device="cpu")
        trainer.model = get_model("CMI")(enc_dict=ENC, config=CONFIGS["CMI"])
    return trainer._attach_host_keys(batch)


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


# ---------------------------------------------------------------------- layers
def _layers(case):
    """(JAX layer, port layer) of a layer case."""
    if case == "self_attention":
        return (jax_mi.MultiInterestSelfAttention(num_interests=K),
                multi_interest.MultiInterestSelfAttention(D, K))
    bilinear = int(case[-1])
    return (jax_mi.CapsuleNetwork(D, L, bilinear_type=bilinear, interest_num=K),
            multi_interest.CapsuleNetwork(D, L, bilinear_type=bilinear, interest_num=K))


@pytest.mark.parametrize("case", ["self_attention", "capsule_0", "capsule_1", "capsule_2"])
def test_layers_match_jax(case):
    rng = np.random.default_rng(1)
    mask = _batch(2)["hist_mask_list"]
    x = rng.standard_normal((B, L, D)).astype(np.float32) * np.float32(0.5)
    w = rng.standard_normal((B, K, D)).astype(np.float32)
    jlayer, layer = _layers(case)
    params = _numpy(jlayer.init(jax.random.PRNGKey(3), x, mask)["params"])

    def f(p, x):
        out = jlayer.apply({"params": p}, x, mask)
        return jnp.sum(out * w), out

    with jax.default_matmul_precision("highest"):
        (_, want), (want_gp, want_gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1),
                                                                   has_aux=True))(params, x)
    load_jax_variables(layer, {"params": params})
    xt = torch.from_numpy(x).requires_grad_()
    mt = torch.from_numpy(mask)
    if case == "capsule_0":  # MIND's gaussian logits, as JAX draws them without a key
        out = layer(xt, mt, torch.from_numpy(_routing_logits()))
    else:
        out = layer(xt, mt)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.shape == (B, K, D)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), rtol=0,
                               atol=_grad_tol(np.asarray(want_gx)))
    _assert_tree_close(jax_tree(layer, lambda t: t.grad), _numpy(want_gp), _grad_tol)


def test_routing_logits_draw_is_seeded():
    """Without given logits MIND's layer draws them on the step's device
    from the step's seed, and serves one kept draw of a fixed seed: the same
    seed, the same interests; another seed, others."""
    layer = multi_interest.CapsuleNetwork(D, L, bilinear_type=0, interest_num=K)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((B, L, D)).astype(np.float32))
    mask = torch.ones(B, L)
    with torch.no_grad():
        serve = [layer(x, mask) for _ in range(2)]
        seeded = [layer(x, mask, seed=s) for s in (7, 7, 8)]
        given = layer(x, mask, multi_interest.draw_routing_logits((B, K, L), 7, CPU))
    torch.testing.assert_close(serve[0], serve[1], rtol=0, atol=0)
    torch.testing.assert_close(seeded[0], seeded[1], rtol=0, atol=0)
    torch.testing.assert_close(given, seeded[0], rtol=0, atol=0)
    kept = multi_interest.draw_routing_logits((B, K, L), None, CPU)
    assert multi_interest.draw_routing_logits((B, K, L), None, CPU) is kept
    assert not torch.equal(seeded[0], seeded[2]) and not torch.equal(serve[0], seeded[0])


# ---------------------------------------------------------------------- models
@functools.lru_cache(maxsize=None)
def jax_model(name):
    """(JAX model, numpy params, jitted serving apply).  Initialized in
    training mode: Re4's fc_cons is built only there."""
    i = MODELS.index(name)
    model = jax_get_model(name)(enc_dict=ENC, config=CONFIGS[name])
    rngs = {"params": jax.random.PRNGKey(i), "dropout": jax.random.PRNGKey(9)}
    variables = jax.jit(lambda r, b: model.init(r, b, True))(rngs, _batch(0, True))
    apply = jax.jit(lambda p, b: model.apply({"params": p}, b, False)["user_emb"])
    return model, _noisy(variables["params"], 20 + i), apply


def _port(name, params, config=None, enc=ENC):
    model = get_model(name)(enc_dict=enc, config=config or CONFIGS[name])
    load_jax_variables(model, {"params": params})
    return model


def _inputs(model, batch, train=False):
    """The uploaded batch; MIND's with JAX's keyless routing logits."""
    inputs = model.upload_batch(batch, CPU, train=train)
    if isinstance(model, get_model("MIND")):
        inputs["routing_logits"] = torch.from_numpy(_routing_logits(len(batch["target_item"])
                                                                    if train else B))
    return inputs


def test_registry_and_flags():
    for name in MODELS:
        cls = get_model(name)
        assert cls.__name__ == name and get_model(name.lower()) is cls
        assert cls.fused_update_compatible
    cmi = get_model("CMI")
    assert (cmi.fused_lookup_key, cmi.lookup_extra, cmi.host_negatives, cmi.fused_uses_ce) == (
        "lookup_all", ("target_item", "neg_items"), True, False)
    assert cmi.renorm_param_paths == (("item_emb", "table"), ("interest_embedding",))
    for name in MODELS[:-1]:
        cls = get_model(name)
        assert not cls.host_negatives and not cls.renorm_param_paths and cls.fused_uses_ce


@pytest.mark.parametrize("name", MODELS)
def test_user_emb_matches_jax(name):
    _, params, apply = jax_model(name)
    batch = _batch(1)
    want = np.asarray(apply(params, batch))
    model = _port(name, params).eval()
    with torch.no_grad():
        got = model(_inputs(model, batch))["user_emb"].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _jax_loss_and_grads(jmodel, params, batch, x64=False):
    """JAX's loss and gradients at ``highest`` precision; with ``x64`` in
    float64 (the weights and the mask widened), as float32 numbers."""
    def loss(p, b):
        return jmodel.apply({"params": p}, b, True,
                            rngs={"dropout": jax.random.PRNGKey(2)})["loss"]

    with jax.default_matmul_precision("highest"), jax.enable_x64(x64):
        if x64:
            params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
            batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                     for k, v in batch.items()}
        value, grads = jax.jit(jax.value_and_grad(loss))(params, batch)
    return float(value), jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grads)


def _check_loss_and_grads(name, batch):
    """Re4's gradients against JAX's in float64: JAX's float32 gradient of
    its re-contrast term drops terms to underflow (see models/sequence/re4.py),
    by up to a third of a leaf's largest entry on these inputs."""
    jmodel, params, _ = jax_model(name)
    want_loss, want_grads = _jax_loss_and_grads(jmodel, params, batch)
    if name == "Re4":
        _, want_grads = _jax_loss_and_grads(jmodel, params, batch, x64=True)
    model = _port(name, params).train()
    out = model(_inputs(model, batch, train=True), train=True, seed=1)
    out["loss"].backward()
    assert np.isfinite(want_loss)
    np.testing.assert_allclose(float(out["loss"].detach()), want_loss, rtol=1e-5)
    _assert_tree_close(jax_tree(model, lambda t: t.grad), want_grads, _grad_tol)
    return model


@pytest.mark.parametrize("name", MODELS)
def test_training_loss_and_gradients_match_jax(name):
    _check_loss_and_grads(name, _train_batch(name, 4))


@pytest.mark.parametrize("n", [7, 8])
def test_cmi_contrastive_term_at_odd_and_even_batch(n):
    """The interests' contrastive loss joins only at an even batch."""
    batch = _train_batch("CMI", 5, n)
    model = _check_loss_and_grads("CMI", batch)
    with torch.no_grad():
        out = model(model.upload_batch(batch, CPU, train=True), train=True, seed=1)
        model.w_clloss = 0.0
        without = model(model.upload_batch(batch, CPU, train=True), train=True, seed=1)
    assert (float(out["loss"]) != float(without["loss"])) == (n % 2 == 0)


def test_target_read_stays_out_of_the_capture():
    """ComirecSA's fused forward captures one lookup (the histories) and the
    CE; the target rows feed only the argmax, without autograd."""
    params = jax_model("ComirecSA")[1]
    model = _port("ComirecSA", params).train()
    calls = []
    lookup = model.item_emb.forward

    def spy(ids, capture=None):
        calls.append((tuple(ids.shape), capture is not None, torch.is_grad_enabled()))
        return lookup(ids, capture)

    model.item_emb.forward = spy
    capture = {"hist": [], "ce": []}
    out = model(model.upload_batch(_batch(3, True), CPU, train=True), train=True,
                capture=capture, seed=1)
    out["loss"].backward()
    assert calls == [((B, L), True, True), ((B,), False, False)]
    assert len(capture["hist"]) == 1 and len(capture["ce"]) == 1


# ------------------------------------------------------------------ train steps
@functools.lru_cache(maxsize=None)
def jax_standard_run(name):
    """Three JAX standard steps from the model's weights (Re4's in float64,
    see ``_check_loss_and_grads``), and the first step's gradients."""
    jmodel, params, _ = jax_model(name)
    trainer = SequenceTrainer(device="cpu")
    trainer.model = _port(name, params)
    batches = [_train_batch(name, s, trainer=trainer) for s in (10, 11, 12)]
    x64 = name == "Re4"
    dtype = np.float64 if x64 else np.float32
    with jax.default_matmul_precision("highest"), jax.enable_x64(x64):
        tx = jax_make_optimizer(LR, 1)
        start = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=start, batch_stats=None,
                           opt_state=tx.init(start), apply_fn=jmodel.apply, tx=tx)
        step = make_train_step(False)
        losses, after_one = [], None
        for b in batches:
            b = {k: v.astype(dtype) if v.dtype == np.float32 else v for k, v in b.items()}
            state, out = step(state, b, jax.random.PRNGKey(1))
            losses.append(float(out["loss"]))
            after_one = after_one or jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), state.params)
    grads = _jax_loss_and_grads(jmodel, params, batches[0], x64)[1]
    return {"after_one": after_one, "losses": losses, "batches": batches, "grads": grads}


def _assert_after_step(got, want, grads):
    """The parameters after one Adam step within atol 1e-6, but within 2 lr
    where the first gradient is rounding noise (within ``_grad_tol`` of 0):
    Adam's first step moves such an element by lr g / (|g| + eps), anywhere
    in [-lr, lr] (SINE's concepts that only an empty history picks)."""
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_grads = dict(jax.tree_util.tree_leaves_with_path(grads))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(flat_want)
    for path, arr in flat_got:
        g = np.asarray(flat_grads[path])
        atol = np.where(np.abs(g) <= _grad_tol(g), 2 * LR, 1e-6)
        diff = np.abs(arr - np.asarray(flat_want[path]))
        assert (diff <= atol).all(), (jax.tree_util.keystr(path), float(diff.max()))


def _run(model, step, batches):
    losses, after_one = [], None
    for i, batch in enumerate(batches):
        out = step(model.upload_batch(batch, CPU, train=True), i)
        losses.append(float(out["loss"].detach()))
        after_one = after_one or jax_variables(model)["params"]
    return losses, after_one


@pytest.mark.parametrize("name", STEP_MODELS)
def test_fused_steps_match_jax_standard_step(name, monkeypatch):
    """K3's ids are the histories (CMI: lookup_all); its dense stream is the
    CE's item gradient (CMI: none)."""
    j = jax_standard_run(name)
    model = _port(name, jax_model(name)[1]).train()
    step = maybe_enable_seq_fused_update(model, LR, 1)
    assert isinstance(step, SeqFusedStep)
    launches = []
    adam_update = fused_update.planned_adam_update

    def record(ids, rows, table, mu, nu, hyper, dense=None):
        launches.append((ids.clone(), rows.shape, None if dense is None else dense.shape))
        return adam_update(ids, rows, table, mu, nu, hyper, dense)

    monkeypatch.setattr(fused_update, "planned_adam_update", record)
    losses, after_one = _run(model, step, j["batches"])
    ids, rows_shape, dense_shape = launches[0]
    key = "lookup_all" if name == "CMI" else "hist_item_list"
    np.testing.assert_array_equal(ids.numpy(), j["batches"][0][key].reshape(-1))
    width = L + 2 if name == "CMI" else L
    assert rows_shape == (B * width, D)
    assert dense_shape == (None if name == "CMI" else (VOCAB, D))
    _assert_after_step(after_one, j["after_one"], j["grads"])
    np.testing.assert_allclose(losses, j["losses"], rtol=1e-5)


def test_comirec_sa_standard_step_matches_fused_step(monkeypatch):
    """The JAX package's own check (tests/test_fused_adam.py,
    test_multi_interest_fused_step_matches_standard) on the port: the loss
    within rtol 1e-6 and the parameters after one step within atol 5e-6."""
    j = jax_standard_run("ComirecSA")
    params = jax_model("ComirecSA")[1]
    fused_model, std_model = _port("ComirecSA", params).train(), _port("ComirecSA", params).train()
    fused_loss, fused = _run(fused_model, maybe_enable_seq_fused_update(fused_model, LR, 1),
                             j["batches"][:1])
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ADAM", "0")
    assert maybe_enable_seq_fused_update(std_model, LR, 1) is None
    std_loss, std = _run(std_model, StandardStep(std_model, LR, 1, generator=torch.Generator()),
                         j["batches"][:1])
    np.testing.assert_allclose(fused_loss, std_loss, rtol=1e-6)
    _assert_tree_close(std, fused, lambda ref: 5e-6)


# ---------------------------------------------------------------------- trainer
def test_cmi_host_negatives_match_jax_trainer():
    """neg_items, then lookup_all = [hist | target | neg], drawn from the
    trainer's shared generator, batch after batch."""
    jmodel, params, _ = jax_model("CMI")
    jtrainer = JaxSequenceTrainer()
    jtrainer.model = jmodel
    trainer = SequenceTrainer(device="cpu")
    trainer.model = _port("CMI", params)
    for seed in (6, 7, 8):
        batch = _batch(seed, True)
        want = jtrainer._attach_plan(dict(batch))
        got = trainer._attach_host_keys(batch)
        assert "neg_items" not in batch
        for key in ("neg_items", "lookup_all"):
            assert got[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
        assert got["lookup_all"].shape == (B, L + 2)
        assert got["neg_items"].min() >= 1 and got["neg_items"].max() < VOCAB - 1
    assert trainer.model.upload_batch(got, CPU, train=True)["lookup_all"].dtype == torch.int32
    kept = dict(batch, neg_items=np.full(B, 3, np.int32))
    assert (trainer._attach_host_keys(kept)["lookup_all"][:, -1] == 3).all()
    with pytest.raises(ValueError, match="lookup_all"):  # the negatives are the trainer's
        trainer.model(trainer.model.upload_batch(batch, CPU, train=True), train=True)


def test_cmi_dropout_draws_its_stream():
    """CMI's embedding dropout multiplies the normalized rows by the hash
    mask of CMI_EMB_DROPOUT for the step's seed."""
    model = get_model("CMI")(enc_dict=ENC, config={**CONFIGS["CMI"], "dropout_prob": 0.3})
    inputs = model.upload_batch(_train_batch("CMI", 9), CPU, train=True)
    seen = []
    gru = model.gru.forward
    model.gru.forward = lambda x: seen.append(x.detach().clone()) or gru(x)
    with torch.no_grad():
        a = model(inputs, train=True, seed=4)["loss"]
        b = model(inputs, train=True, seed=4)["loss"]
        c = model(inputs, train=True, seed=5)["loss"]
        rows = cmi_module.stopgrad_norm(model.item_emb(inputs["hist_item_list"]))
    torch.testing.assert_close(seen[0], feature_dropout(rows, 0.3, 4, CMI_EMB_DROPOUT),
                               rtol=0, atol=0)
    assert a == b and a != c


def test_renorm_keeps_zero_rows_and_leaves_moments():
    model = get_model("CMI")(enc_dict=ENC, config=CONFIGS["CMI"])
    with torch.no_grad():
        model.item_emb.table[5].zero_()
        model.item_emb.table[6].mul_(1e-3)
    renorm = make_param_renorm(model, model.renorm_param_paths)
    renorm()
    norms = torch.linalg.vector_norm(model.item_emb.table, dim=-1)
    assert torch.equal(model.item_emb.table[5], torch.zeros(D))
    torch.testing.assert_close(norms[torch.arange(VOCAB) != 5], torch.ones(VOCAB - 1),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.linalg.vector_norm(model.interest_embedding, dim=-1),
                               torch.ones(8), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="no weights"):
        make_param_renorm(model, (("nope",),))


def _seq_loaders(seq_dfs, max_length=20):
    schema = {**SEQ_SCHEMA, "max_length": max_length}
    return get_dataloader(*seq_dfs, schema, batch_size=256)


def test_cmi_fit_projects_like_jax(seq_dfs, tmp_path, monkeypatch):
    """The projection at fit's start and after every step equals the JAX
    ``make_param_renorm`` of the weights it is given."""
    loaders = _seq_loaders(seq_dfs)
    enc = loaders[3]
    config = {**CONFIGS["CMI"], "max_length": 20}
    model = get_model("CMI")(enc_dict=enc, config=config, seed=3)
    jax_renorm = jax_make_param_renorm(model.renorm_param_paths)
    seen = []

    def recording(m, paths):
        inner = make_param_renorm(m, paths)

        def renorm():
            before = jax_variables(m)["params"]
            inner()
            seen.append((before, jax_variables(m)["params"]))

        return renorm

    monkeypatch.setattr(trainer_module, "make_param_renorm", recording)
    trainer = SequenceTrainer(model_ckpt_dir=str(tmp_path), device="cpu")
    trainer.fit(model, loaders[0], None, epoch=1, lr=1e-3)
    assert isinstance(trainer._train_step, SeqFusedStep)
    assert len(seen) == 1 + len(loaders[0])
    for before, after in seen:
        want = _numpy(jax_renorm(jax.tree_util.tree_map(jnp.asarray, before)))
        _assert_tree_close(after, want, lambda ref: 1e-6)
    table = model.item_emb.table.detach()
    norms = torch.linalg.vector_norm(table, dim=-1)
    assert bool(((norms - 1).abs() < 1e-5).all())


@pytest.mark.parametrize("name", ["ComirecSA", "CMI"])
def test_fit_checkpoint_and_retrieval_on_bundled_data(name, seq_dfs, tmp_path):
    loaders = _seq_loaders(seq_dfs)
    enc = loaders[3]
    config = {**CONFIGS[name], "max_length": 20}
    model = get_model(name)(enc_dict=enc, config=config, seed=4)
    start = model.item_emb.table.detach().clone()
    trainer = SequenceTrainer(model_ckpt_dir=str(tmp_path), device="cpu")
    trainer.fit(model, loaders[0], loaders[1], epoch=1, lr=1e-3,
                use_earlystopping=True, monitor_metric="recall@20")
    assert isinstance(trainer._train_step, SeqFusedStep)
    assert not torch.equal(model.item_emb.table.detach(), start)
    assert {"log.csv", "model_e_1.ckpt", "model_best.ckpt"} <= set(
        p.name for p in tmp_path.iterdir())
    path = trainer.save_all(model, enc, str(tmp_path / "all"))
    loaded = get_model(name)(enc_dict=enc, config=config, seed=5)
    SequenceTrainer(device="cpu").load_model(loaded, path)
    batch = {k: v for k, v in next(iter(loaders[2])).items() if k.startswith("hist_")}
    want = make_retrieval_scorer(model, topk=20, device="cpu")(batch)
    got = make_retrieval_scorer(loaded, topk=20, device="cpu")(batch)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].shape == (len(batch["hist_item_list"]), 20) and got[1].min() >= 1


def test_evaluate_model_matches_jax_on_bundled_data_comirec_sa(seq_dfs, tmp_path):
    """Multi-interest retrieval: B K queries merged per user by score."""
    loaders = _seq_loaders(seq_dfs)
    enc = loaders[3]
    config = {**CONFIGS["ComirecSA"], "max_length": 20}
    jmodel = jax_get_model("ComirecSA")(enc_dict=enc, config=config)
    sample = {k: v for k, v in next(iter(loaders[2])).items() if k.startswith("hist_")}
    params = jax.jit(lambda r, b: jmodel.init(r, b, False))(
        {"params": jax.random.PRNGKey(5)}, sample)["params"]
    jtrainer = JaxSequenceTrainer(model_ckpt_dir=str(tmp_path))
    tx = jax_make_optimizer(1e-3, 1)
    jtrainer.state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=None,
                                opt_state=tx.init(params), apply_fn=jmodel.apply, tx=tx)
    jtrainer.model, jtrainer._has_bs = jmodel, False
    model = _port("ComirecSA", _numpy(params), config, enc)
    want = jtrainer.evaluate_model(jmodel, loaders[2])
    got = SequenceTrainer(device="cpu").evaluate_model(model, loaders[2])
    assert list(got) == [f"{m}@{k}" for k in (20, 50, 100) for m in ("recall", "ndcg", "hitrate")]
    assert got == want
