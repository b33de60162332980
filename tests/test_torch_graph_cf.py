"""Graph CF on the port against the JAX package: ``GeneralGraphDataset``,
NGCF from transplanted weights and ``GraphTrainer``.

Tolerances: R_norm within 1e-7 (the degree scalings' powers may round
apart by an ulp); with dropout 0, the concatenated embeddings within
1e-5, the BPR loss within 1e-6 relative, each leaf's gradient within 1e-5
of its largest entry and the weights after three Adam steps at lr 1e-3
within 1e-6 (the same float32 products summed in other orders; Adam moves
an element whose gradient is a rounding away from 0 by up to lr a step,
so the trajectory is held at the trainers' default rate).  ``evaluate_model``
equals the host oracle (argsort, then the train items filtered out) and
the JAX trainer's metrics on the same weights exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rec_pangu_tpu.data.graph_dataset import GeneralGraphDataset as JaxGraphDataset
from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.train import GraphTrainer as JaxGraphTrainer
from rec_pangu_tpu.train import optim as jax_optim
from rec_pangu_tpu.train.ckpt import load_checkpoint as jax_load_checkpoint
from rec_pangu_tpu_torch import GraphTrainer, get_model
from rec_pangu_tpu_torch.convert import jax_variables, load_jax_variables
from rec_pangu_tpu_torch.data import GeneralGraphDataset
from rec_pangu_tpu_torch.eval.retrieval import evaluate_recall
from rec_pangu_tpu_torch.train.steps import StandardStep

NUM_USER, NUM_ITEM, DIM, HIDDEN = 30, 40, 8, (8, 8)
LR = 1e-2
ADAM_LR = 1e-3   # the trainers' default rate
CPU = torch.device("cpu")


def _frame(seed: int, n: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"user_id": rng.integers(0, NUM_USER, n),
                         "item_id": rng.integers(0, NUM_ITEM, n)}).drop_duplicates()


@pytest.fixture(scope="module")
def frames():
    return _frame(0, 400), _frame(1, 100)


def _jax_model(g, dropout=0.0):
    return jax_get_model("NGCF")(num_user=NUM_USER, num_item=NUM_ITEM, embedding_dim=DIM,
                                 hidden_size=list(HIDDEN), g=g, dropout=dropout)


def _port_model(g, params=None, dropout=0.0, seed=7):
    model = get_model("NGCF")(num_user=NUM_USER, num_item=NUM_ITEM, embedding_dim=DIM,
                              hidden_size=HIDDEN, g=g, dropout=dropout, seed=seed)
    if params is not None:
        load_jax_variables(model, {"params": params})
    return model


@pytest.fixture(scope="module")
def jax_start(frames):
    ds = JaxGraphDataset(frames[0], NUM_USER, NUM_ITEM)
    g = ds.generate_graph()
    model = _jax_model(g)
    params = model.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                        ds.sample(16), True)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params), g


def test_dataset_batches_and_graph_equal_jax(frames):
    for frame in (frames[0], {"user_id": frames[0]["user_id"].to_numpy(),
                              "item_id": frames[0]["item_id"].to_numpy()}):
        jds = JaxGraphDataset(frames[0], NUM_USER, NUM_ITEM, seed=11)
        tds = GeneralGraphDataset(frame, NUM_USER, NUM_ITEM, seed=11)
        assert tds.test_gd == jds.test_gd and tds.user_list == jds.user_list
        assert len(tds) == len(jds)
        for size in (16, 64, 64):  # 64 > 30 users: drawn with replacement
            want, got = jds.sample(size), tds.sample(size)
            assert want.keys() == got.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    g = tds.generate_graph(CPU)
    assert g.dtype == torch.float32 and g.device == CPU
    np.testing.assert_allclose(g.numpy(), jds.generate_graph(), rtol=0, atol=1e-7)
    test = GeneralGraphDataset(frames[1], NUM_USER, NUM_ITEM, phase="test")
    assert len(test) == len(test.user_list)


def test_ngcf_embeddings_loss_and_gradients_match_jax(frames, jax_start):
    model, params, g = jax_start
    port = _port_model(torch.from_numpy(g), params)
    assert set(port.state_dict()) == {n for n, _ in port.named_parameters()}  # g not saved
    ds = JaxGraphDataset(frames[0], NUM_USER, NUM_ITEM, seed=5)
    batch = ds.sample(32)
    want = model.apply({"params": params}, {}, False)
    with torch.no_grad():
        got = port({}, train=False)
    for key in ("user_emb", "item_emb"):
        assert got[key].shape == (want[key].shape[0], DIM * (1 + len(HIDDEN)))
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5)

    def loss_fn(p):
        return model.apply({"params": p}, batch, True)["loss"]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    out = port(port.upload_batch(batch, CPU, train=True), train=True, seed=0)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(want_loss), rtol=1e-6)
    flat = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    for _, path, tensor, transposed in port.jax_leaves():
        key = next(k for k in flat if tuple(p.key for p in k) == path)
        ref = np.asarray(flat[key])
        grad = tensor.grad.numpy()
        grad = grad.T if transposed else grad
        np.testing.assert_allclose(grad, ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg="/".join(path))


def test_three_adam_steps_match_jax(frames, jax_start):
    model, params, g = jax_start
    ds = JaxGraphDataset(frames[0], NUM_USER, NUM_ITEM, seed=9)
    batches = [ds.sample(32) for _ in range(3)]
    tx = jax_optim.make_optimizer(ADAM_LR, 1)
    p, state = jax.tree_util.tree_map(jnp.asarray, params), None
    state = tx.init(p)
    grad_fn = jax.grad(lambda q, b: model.apply({"params": q}, b, True)["loss"])
    for b in batches:
        updates, state = tx.update(grad_fn(p, b), state, p)
        p = jax.tree_util.tree_map(lambda a, u: a + u, p, updates)
    port = _port_model(torch.from_numpy(g), params)
    step = StandardStep(port, ADAM_LR, 1, generator=torch.Generator().manual_seed(0))
    for i, b in enumerate(batches):
        step(port.upload_batch(b, CPU, train=True), i)
    got = jax_variables(port)["params"]
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6), got, p)


def test_dropout_masks_are_seeded(frames):
    ds = GeneralGraphDataset(frames[0], NUM_USER, NUM_ITEM)
    port = _port_model(ds.generate_graph(CPU), dropout=0.5)
    inputs = port.upload_batch(ds.sample(32), CPU, train=True)
    with torch.no_grad():
        a, b, c = (port(inputs, train=True, seed=s)["loss"] for s in (1, 1, 2))
        plain = _port_model(ds.generate_graph(CPU), dropout=0.0)(inputs, train=True)["loss"]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, plain)
    with pytest.raises(ValueError, match="out of range"):
        port.upload_batch({**ds.sample(4), "neg_item_id": np.full(4, NUM_ITEM, np.int32)},
                          CPU, train=True)


def test_graph_trainer_fit_and_evaluate(frames, tmp_path):
    train_ds = GeneralGraphDataset(frames[0], NUM_USER, NUM_ITEM)
    test_ds = GeneralGraphDataset(frames[1], NUM_USER, NUM_ITEM, phase="test")
    model = _port_model(train_ds.generate_graph(CPU), dropout=0.1)
    trainer = GraphTrainer(model_ckpt_dir=str(tmp_path), device="cpu")
    before = model.user_emb.detach().clone()
    trainer.fit(model, train_ds, epoch=2, lr=LR, batch_size=64)
    assert trainer.step == 2 * (len(train_ds) // 64)
    assert not torch.equal(before, model.user_emb.detach())
    metrics = trainer.evaluate_model(model, train_ds, test_ds, topN=20)
    assert set(metrics) == {"recall@20", "ndcg@20", "hitrate@20"}

    # the host oracle: argsort of every item, then the train items dropped
    with torch.no_grad():
        out = model({}, train=False)
    users, items = out["user_emb"].numpy(), out["item_emb"].numpy()
    oracle = {}
    for u in test_ds.test_gd:
        top = np.argsort(-(users[u] @ items.T))[:min(1000, items.shape[0])]
        seen = set(train_ds.test_gd.get(u, []))
        oracle[u] = [int(x) for x in top if int(x) not in seen]
    assert metrics == evaluate_recall(oracle, test_ds.test_gd, 20)

    # the JAX trainer's metrics from the same weights
    jtrain = JaxGraphDataset(frames[0], NUM_USER, NUM_ITEM)
    jtest = JaxGraphDataset(frames[1], NUM_USER, NUM_ITEM, phase="test")
    jmodel = _jax_model(jtrain.generate_graph())
    jtrainer = JaxGraphTrainer(model_ckpt_dir=str(tmp_path / "jax"))
    jtrainer._build_state(jmodel, jtrain.sample(8), LR, 1)
    jtrainer.state = jtrainer.state.replace(params=jax_variables(model)["params"])
    assert jtrainer.evaluate_model(jmodel, jtrain, jtest, topN=20) == metrics

    # the JAX package reads the port's checkpoint
    path = trainer.save_model(model, str(tmp_path))
    saved = jax_load_checkpoint(path)
    want = jmodel.apply({"params": saved["params"]}, {}, False)
    np.testing.assert_allclose(np.asarray(want["user_emb"]), users, rtol=0, atol=1e-5)


def test_fit_refuses_a_mesh(frames, tmp_path):
    """fit runs under a mesh (``tests/test_torch_trainer_mesh.py``); it
    refuses one that ``parallel.make_mesh`` did not make, before any step."""
    ds = GeneralGraphDataset(frames[0], NUM_USER, NUM_ITEM)
    model = _port_model(ds.generate_graph(CPU))
    with pytest.raises(TypeError, match="DeviceMesh from parallel.make_mesh"):
        GraphTrainer(model_ckpt_dir=str(tmp_path), device="cpu").fit(model, ds, mesh=object())
