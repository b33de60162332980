"""The session-graph family (SRGNN, GCSAN, NISER) and its graph ops in the
port against the JAX package.

Histories come from a numpy seed, with repeated items, lengths 0, 1 and L
and a mask that is not a prefix.  Weights are made by the JAX package
(small random biases and LayerNorm scales, so that every term counts) and
carried across by ``convert.py``; dropout is off in the comparisons with
JAX.  Tolerances:

* the host graph (``host_session_graph``) and the device graph
  (``build_session_graph``: nodes, alias, M_in, M_out) bit-equal to the JAX
  package's, and ``adj_from_alias`` of the host alias equal to the device
  build's adjacencies;
* ``take_nodes`` and the SR-GNN cell within atol 1e-5, their gradients
  within 1e-5 of each array's largest entry;
* ``user_emb`` within atol 1e-5 on both graph paths (the device build and
  the host graph); the training loss within rtol 1e-5 and the first step's
  gradients within 1e-5 of each leaf's largest entry (JAX at ``highest``
  precision);
* three sequence fused steps (its ids the host graph's nodes) against three
  JAX standard steps: the parameters after one step within atol 1e-6, the
  losses within rtol 1e-5; the port's standard step against its fused step
  within atol 1e-6.  GCSAN's key biases have a gradient of exactly 0 (a
  softmax does not change when a query adds q.b to all its scores), so
  Adam's first step moves them lr times the sign of a rounding: held within
  2 lr, as SASRec's are;
* ``SequenceTrainer.fit`` on the bundled data attaches the host graph and
  takes the fused step; ``evaluate_model`` (the device build) equals the
  JAX trainer's on the same weights.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.ops import graph as jax_graph
from rec_pangu_tpu.train import SequenceTrainer as JaxSequenceTrainer
from rec_pangu_tpu.train.optim import make_optimizer as jax_make_optimizer
from rec_pangu_tpu.train.steps import TrainState, make_train_step
from rec_pangu_tpu_torch.convert import jax_tree, jax_variables, load_jax_variables
from rec_pangu_tpu_torch.data import get_dataloader
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.models.sequence import srgnn as srgnn_module
from rec_pangu_tpu_torch.ops import graph
from rec_pangu_tpu_torch.ops.sequence_enc import NISER_ITEM_DROPOUT, feature_dropout
from rec_pangu_tpu_torch.train import SequenceTrainer
from rec_pangu_tpu_torch.train import fused_update
from rec_pangu_tpu_torch.train.fused_update import SeqFusedStep, maybe_enable_seq_fused_update
from rec_pangu_tpu_torch.train.steps import StandardStep

from conftest import SEQ_SCHEMA

B, L, VOCAB, D, LR = 16, 12, 50, 16, 1e-3
ENC = {"item_id": {"vocab_size": VOCAB}}
BASE = {"embedding_dim": D, "max_length": L, "item_col": "item_id"}
CONFIGS = {"SRGNN": BASE,
           "GCSAN": {**BASE, "n_layers": 2, "n_heads": 4, "inner_size": 32,
                     "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0},
           "NISER": {**BASE, "item_dropout": 0.0}}
MODELS = tuple(CONFIGS)
CPU = torch.device("cpu")
ZERO_GRAD = "['key']['bias']"  # exact gradients of 0: Adam moves them by noise
NOT_PREFIX = np.array([0, 1, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0], np.float32)  # row 3's mask


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _batch(seed, train=False, n=B):
    """Histories over few items (repeats in most rows), lengths 0, 1, L in
    rows 0-2 and row 3's mask not a prefix; padded positions hold 0."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, n)
    lens[:3] = (0, 1, L)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    mask[3] = NOT_PREFIX
    hist = np.where(mask > 0, rng.integers(1, 9, (n, L)), 0).astype(np.int32)
    batch = {"hist_item_list": hist, "hist_mask_list": mask}
    if train:
        batch["target_item"] = rng.integers(1, VOCAB, n).astype(np.int32)
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



def _assert_after_step(got, want):
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(flat_want)
    for path, arr in flat_got:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(arr, np.asarray(flat_want[path]), rtol=0,
                                   atol=2 * LR if ZERO_GRAD in key else 1e-6, err_msg=key)


# ---------------------------------------------------------------------- graphs
@pytest.mark.parametrize("seed", [0, 1])
def test_session_graphs_bit_equal_jax(seed):
    batch = _batch(seed, n=64)
    hist, mask = batch["hist_item_list"], batch["hist_mask_list"]
    want = [np.asarray(a) for a in jax.jit(jax_graph.build_session_graph)(hist, mask)]
    want_host = jax_graph.host_session_graph(hist, mask)
    got_host = graph.host_session_graph(hist, mask)
    for got, ref in zip(got_host, want_host):
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_host[0], want[0])
    np.testing.assert_array_equal(got_host[1], want[1])
    got = [t.numpy() for t in graph.build_session_graph(torch.from_numpy(hist),
                                                        torch.from_numpy(mask))]
    for g, ref in zip(got, want):
        np.testing.assert_array_equal(g, ref)
    m_in, m_out = graph.adj_from_alias(torch.from_numpy(got_host[1]), torch.from_numpy(mask))
    np.testing.assert_array_equal(m_in.numpy(), want[2])
    np.testing.assert_array_equal(m_out.numpy(), want[3])
    # an empty history: node 0 everywhere, alias 0, no edges
    assert (got[0][0] == 0).all() and (got[1][0] == 0).all() and not got[2][0].any()
    attached = graph.attach_session_graph(dict(batch))
    np.testing.assert_array_equal(attached["graph_nodes"], want_host[0])
    assert graph.attach_session_graph(attached) is attached


def test_take_nodes_and_cell_match_jax():
    rng = np.random.default_rng(2)
    batch = _batch(3)
    hist, mask = batch["hist_item_list"], batch["hist_mask_list"]
    _, alias, m_in, m_out = (np.array(a) for a in jax_graph.build_session_graph(hist, mask))
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    cell = jax_graph.SRGNNCell(D)
    params = _noisy(cell.init(jax.random.PRNGKey(0), m_in, m_out, x)["params"], 4)
    w = rng.standard_normal((B, L, D)).astype(np.float32)

    def f(p, x):
        out = jax_graph.take_nodes(cell.apply({"params": p}, m_in, m_out, x), alias)
        return jnp.sum(out * w), out

    with jax.default_matmul_precision("highest"):
        (_, want), (want_gp, want_gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1),
                                                                   has_aux=True))(params, x)
    port = graph.SRGNNCell(D)
    load_jax_variables(port, {"params": params})
    xt = torch.from_numpy(x).requires_grad_()
    out = graph.take_nodes(port(torch.from_numpy(m_in), torch.from_numpy(m_out), xt),
                           torch.from_numpy(alias))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), rtol=0,
                               atol=_grad_tol(np.asarray(want_gx)))
    _assert_tree_close(jax_tree(port, lambda t: t.grad), _numpy(want_gp), _grad_tol)
    # the read itself is exact: one nonzero term a row
    h = torch.from_numpy(x)
    np.testing.assert_array_equal(graph.take_nodes(h, torch.from_numpy(alias)).numpy(),
                                  np.take_along_axis(x, alias[..., None].astype(np.int64),
                                                     axis=1))


# ---------------------------------------------------------------------- models
@functools.lru_cache(maxsize=None)
def jax_model(name):
    """(JAX model, numpy params, jitted serving apply)."""
    i = MODELS.index(name)
    model = jax_get_model(name)(enc_dict=ENC, config=CONFIGS[name])
    rngs = {"params": jax.random.PRNGKey(i), "dropout": jax.random.PRNGKey(9)}
    variables = jax.jit(lambda r, b: model.init(r, b, False))(rngs, _batch(0))
    apply = jax.jit(lambda p, b: model.apply({"params": p}, b, False)["user_emb"])
    return model, _noisy(variables["params"], 20 + i), apply


def _port(name, params, config=None, enc=ENC):
    model = get_model(name)(enc_dict=enc, config=config or CONFIGS[name])
    load_jax_variables(model, {"params": params})
    return model


def test_registry_and_flags():
    for name in MODELS:
        cls = get_model(name)
        assert cls.__name__ == name and get_model(name.lower()) is cls
        assert cls.session_graph and cls.fused_update_compatible
        assert cls.fused_lookup_key == "graph_nodes"


@pytest.mark.parametrize("path", ["device_build", "host_graph"])
@pytest.mark.parametrize("name", MODELS)
def test_user_emb_matches_jax(name, path):
    _, params, apply = jax_model(name)
    batch = _batch(1)
    want = np.asarray(apply(params, batch))
    if path == "host_graph":
        batch = graph.attach_session_graph(batch)
    model = _port(name, params).eval()
    inputs = model.upload_batch(batch, CPU)
    assert ("graph_nodes" in inputs) == (path == "host_graph")
    with torch.no_grad():
        got = model(inputs)["user_emb"].numpy()
    assert got.shape == (B, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_upload_checks_the_host_graph():
    model = get_model("SRGNN")(enc_dict=ENC, config=BASE)
    batch = graph.attach_session_graph(_batch(2))
    inputs = model.upload_batch(batch, CPU, train=False)
    assert inputs["graph_nodes"].dtype == inputs["graph_alias"].dtype == torch.int32
    bad = dict(batch, graph_alias=np.full((B, L), L, np.int32))
    with pytest.raises(ValueError, match="graph_alias"):
        model.upload_batch(bad, CPU)
    with pytest.raises(ValueError, match="out of range"):
        model.upload_batch(dict(batch, graph_nodes=np.full((B, L), VOCAB, np.int32)), CPU)


def _jax_loss_and_grads(jmodel, params, batch):
    def loss(p):
        return jmodel.apply({"params": p}, batch, True,
                            rngs={"dropout": jax.random.PRNGKey(2)})["loss"]

    with jax.default_matmul_precision("highest"):
        value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), _numpy(grads)


@pytest.mark.parametrize("name", MODELS)
def test_training_loss_and_gradients_match_jax(name):
    jmodel, params, _ = jax_model(name)
    batch = graph.attach_session_graph(_batch(4, train=True))
    want_loss, want_grads = _jax_loss_and_grads(jmodel, params, batch)
    model = _port(name, params).train()
    out = model(model.upload_batch(batch, CPU, train=True), train=True, seed=1)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), want_loss, rtol=1e-5)
    _assert_tree_close(jax_tree(model, lambda t: t.grad), want_grads, _grad_tol)


def test_niser_item_dropout_draws_its_stream():
    """NISER's item dropout multiplies the node embeddings by the hash mask
    of NISER_ITEM_DROPOUT for the step's seed."""
    model = get_model("NISER")(enc_dict=ENC, config={**BASE, "item_dropout": 0.3})
    inputs = model.upload_batch(graph.attach_session_graph(_batch(9, train=True)), CPU,
                                train=True)
    seen = []
    safe_l2norm = srgnn_module.safe_l2norm

    def spy(x, *a, **k):  # the first norm is of the dropped node embeddings
        seen.append(x.detach().clone())
        return safe_l2norm(x, *a, **k)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(srgnn_module, "safe_l2norm", spy)
        a = model(inputs, train=True, seed=4)["loss"]
        b = model(inputs, train=True, seed=4)["loss"]
        c = model(inputs, train=True, seed=5)["loss"]
    rows = model.item_emb(inputs["graph_nodes"])
    torch.testing.assert_close(seen[0], feature_dropout(rows, 0.3, 4, NISER_ITEM_DROPOUT),
                               rtol=0, atol=0)
    assert a == b and a != c


# ------------------------------------------------------------------ train steps
@functools.lru_cache(maxsize=None)
def jax_standard_run(name):
    """Three JAX standard steps from the model's weights, on host-graph
    batches."""
    jmodel, params, _ = jax_model(name)
    batches = [graph.attach_session_graph(_batch(s, train=True)) for s in (10, 11, 12)]
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
    return {"after_one": after_one, "losses": losses, "batches": batches}


def _run(model, step, batches):
    losses, after_one = [], None
    for i, batch in enumerate(batches):
        out = step(model.upload_batch(batch, CPU, train=True), i)
        losses.append(float(out["loss"].detach()))
        after_one = after_one or jax_variables(model)["params"]
    return losses, after_one


@pytest.mark.parametrize("name", MODELS)
def test_fused_steps_match_jax_standard_step(name, monkeypatch):
    """K3's ids are the host graph's nodes; the dense item gradient is the
    CE's."""
    j = jax_standard_run(name)
    model = _port(name, jax_model(name)[1]).train()
    step = maybe_enable_seq_fused_update(model, LR, 1)
    assert isinstance(step, SeqFusedStep)
    launches = []
    adam_update = fused_update.planned_adam_update

    def record(ids, rows, table, mu, nu, hyper, dense=None):
        launches.append((ids.clone(), rows.shape, dense.shape))
        return adam_update(ids, rows, table, mu, nu, hyper, dense)

    monkeypatch.setattr(fused_update, "planned_adam_update", record)
    losses, after_one = _run(model, step, j["batches"])
    ids, rows_shape, dense_shape = launches[0]
    np.testing.assert_array_equal(ids.numpy(), j["batches"][0]["graph_nodes"].reshape(-1))
    assert rows_shape == (B * L, D) and dense_shape == (VOCAB, D)
    _assert_after_step(after_one, j["after_one"])
    np.testing.assert_allclose(losses, j["losses"], rtol=1e-5)
    with pytest.raises(ValueError, match="graph_nodes"):
        step(model.upload_batch(_batch(13, train=True), CPU, train=True), 3)


@pytest.mark.parametrize("name", MODELS)
def test_standard_step_matches_fused_step(name, monkeypatch):
    j = jax_standard_run(name)
    params = jax_model(name)[1]
    fused_model, std_model = _port(name, params).train(), _port(name, params).train()
    _, fused = _run(fused_model, maybe_enable_seq_fused_update(fused_model, LR, 1),
                    j["batches"][:1])
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ADAM", "0")
    assert maybe_enable_seq_fused_update(std_model, LR, 1) is None
    _, std = _run(std_model, StandardStep(std_model, LR, 1, generator=torch.Generator()),
                  j["batches"][:1])
    _assert_after_step(std, fused)


def test_fit_and_evaluate_srgnn_on_bundled_data(seq_dfs, tmp_path):
    """``fit`` attaches the host graph to every training batch (the fused
    step's ids are its nodes); ``evaluate_model`` builds the graph on the
    device and equals the JAX trainer's metrics on the same weights."""
    schema = {**SEQ_SCHEMA, "max_length": 20}
    config = {"embedding_dim": 16, "max_length": 20}
    loaders = get_dataloader(*seq_dfs, schema, batch_size=1024)
    enc = loaders[3]
    jmodel = jax_get_model("SRGNN")(enc_dict=enc, config=config)
    sample = {k: v for k, v in next(iter(loaders[2])).items() if k.startswith("hist_")}
    rngs = {"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)}
    params = jax.jit(lambda r, b: jmodel.init(r, b, False))(rngs, sample)["params"]
    model = _port("SRGNN", _numpy(params), config, enc)
    trainer = SequenceTrainer(model_ckpt_dir=str(tmp_path), device="cpu")
    seen = []
    step = trainer._step
    trainer._step = lambda batch: seen.append(sorted(batch)) or step(batch)
    trainer.fit(model, loaders[0], None, epoch=1, lr=1e-3)
    assert isinstance(trainer._train_step, SeqFusedStep)
    assert seen and all("graph_nodes" not in keys for keys in seen)  # attached in _step
    trained = jax_variables(model)["params"]
    assert not np.array_equal(trained["item_emb"]["table"], np.asarray(params["item_emb"]["table"]))
    jtrainer = JaxSequenceTrainer(model_ckpt_dir=str(tmp_path / "jax"))
    tx = jax_make_optimizer(1e-3, 1)
    jparams = jax.tree_util.tree_map(jnp.asarray, trained)
    jtrainer.state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams, batch_stats=None,
                                opt_state=tx.init(jparams), apply_fn=jmodel.apply, tx=tx)
    jtrainer.model, jtrainer._has_bs = jmodel, False
    want = jtrainer.evaluate_model(jmodel, loaders[2])
    got = SequenceTrainer(device="cpu").evaluate_model(model, loaders[2])
    assert list(got) == [f"{m}@{k}" for k in (20, 50, 100) for m in ("recall", "ndcg", "hitrate")]
    assert got == want
