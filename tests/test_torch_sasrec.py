"""SASRec served by the port against the JAX package's SASRec.

Weights are made by the JAX package and carried across (``load_jax_variables``
or a checkpoint).  ``user_emb`` is held within atol 1e-5 of the JAX model on
its flax path (every row, empty histories included) and on its fused Pallas
encoder in interpret mode (the rows whose gathered position has a valid
key): float32 on both sides, summed in other orders.  Retrieval metrics on
the bundled data equal the JAX ``SequenceTrainer``'s to the 4 dp both round
to, and the retrieval scorer's top-k ids equal JAX's where neighbouring
scores are further apart than that tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.serving import make_retrieval_scorer as jax_make_retrieval_scorer
from rec_pangu_tpu.train import SequenceTrainer as JaxSequenceTrainer
from rec_pangu_tpu.train.ckpt import load_checkpoint as jax_load_checkpoint
from rec_pangu_tpu.train.ckpt import save_checkpoint as jax_save_checkpoint
from rec_pangu_tpu.train.optim import make_optimizer
from rec_pangu_tpu.train.steps import create_train_state
from rec_pangu_tpu_torch.convert import load_jax_variables
from rec_pangu_tpu_torch.data import get_dataloader
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.serving import make_retrieval_scorer
from rec_pangu_tpu_torch.train import SequenceTrainer

from conftest import SEQ_SCHEMA

B, L, VOCAB = 16, 12, 50
CONFIG = {"embedding_dim": 8, "max_length": L, "n_heads": 2, "inner_size": 16,
          "n_layers": 2, "item_col": "item_id"}
ATOL = 1e-5


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, B)
    lens[[3, 11]] = 0  # empty histories: every query of the sample is masked
    hist = np.zeros((B, L), np.int32)
    mask = np.zeros((B, L), np.float32)
    for i, n in enumerate(lens):
        hist[i, :n] = rng.integers(1, VOCAB, n)
        mask[i, :n] = 1.0
    return {"hist_item_list": hist, "hist_mask_list": mask}, lens


@pytest.fixture(scope="module")
def jax_sasrec():
    enc = {"item_id": {"vocab_size": VOCAB}}
    model = jax_get_model("SASRec")(enc_dict=enc, config=CONFIG)
    variables = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                           _batch()[0], False)
    return model, _numpy(variables["params"]), enc


def _port(params, enc, config=CONFIG):
    model = get_model("SASRec")(enc_dict=enc, config=config)
    load_jax_variables(model, {"params": params})
    return model.eval()


def _user_emb(model, batch):
    with torch.no_grad():
        return model(model.upload_batch(batch, torch.device("cpu")))["user_emb"].numpy()


def test_user_emb_matches_jax_flax_path(jax_sasrec, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    model, params, enc = jax_sasrec
    batch, _ = _batch(1)
    want = np.asarray(model.apply({"params": params}, batch, False)["user_emb"])
    got = _user_emb(_port(params, enc), batch)
    assert got.shape == (B, CONFIG["embedding_dim"])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_user_emb_matches_jax_fused_encoder_interpret(jax_sasrec, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "1")
    from rec_pangu_tpu.ops.kernels import fused_encoder as jfe

    calls = []
    pack_call = jfe._pack_call

    def counting(*args, **kwargs):
        calls.append(1)
        return pack_call(*args, **kwargs)

    monkeypatch.setattr(jfe, "_pack_call", counting)
    model, params, enc = jax_sasrec
    batch, lens = _batch(2)
    want = np.asarray(model.apply({"params": params}, batch, False)["user_emb"])
    assert calls, "the JAX SASRec did not reach the Pallas encoder"
    got = _user_emb(_port(params, enc), batch)
    rows = lens > 0  # an empty history reads a query row with no valid key
    np.testing.assert_allclose(got[rows], want[rows], rtol=0, atol=ATOL)


def test_retrieval_scorer_matches_jax(jax_sasrec, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    model, params, enc = jax_sasrec
    batch, _ = _batch(3)
    topk = 20
    want_s, want_i = (np.asarray(a) for a in jax_make_retrieval_scorer(
        model, {"params": params}, topk=topk)(batch))
    got_s, got_i = make_retrieval_scorer(_port(params, enc), topk=topk, device="cpu")(batch)
    assert got_s.shape == got_i.shape == (B, topk)
    assert got_i.dtype == np.int32
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=ATOL)
    # tie-free rows: every neighbouring pair of the JAX scores (one past the
    # top-k included) lies further apart than the tolerance
    full = np.sort(np.asarray(jax_make_retrieval_scorer(
        model, {"params": params}, topk=topk + 1)(batch)[0]), axis=1)
    tie_free = (np.diff(full, axis=1) > 2 * ATOL).all(axis=1)
    assert tie_free.sum() >= B // 2
    np.testing.assert_array_equal(got_i[tie_free], want_i[tie_free])


def test_evaluate_model_matches_jax_on_bundled_data(seq_dfs, tmp_path):
    schema = {**SEQ_SCHEMA, "max_length": 20}
    config = {**CONFIG, "max_length": 20, "cate_cols": ["genre"]}
    loaders = get_dataloader(*seq_dfs, schema, batch_size=64)
    enc = loaders[3]
    jmodel = jax_get_model("SASRec")(enc_dict=enc, config=config)
    sample = {k: v for k, v in next(iter(loaders[2])).items() if k.startswith("hist_")}
    jtrainer = JaxSequenceTrainer(model_ckpt_dir=str(tmp_path))
    jtrainer.state = create_train_state(jmodel, sample, make_optimizer(1e-3, 1),
                                        jax.random.PRNGKey(5), train=False)
    jtrainer.model, jtrainer._has_bs = jmodel, False
    tmodel = _port(_numpy(jtrainer.state.params), enc, config)
    trainer = SequenceTrainer(device="cpu")
    for loader in loaders[1:3]:
        want = jtrainer.evaluate_model(jmodel, loader)
        got = trainer.evaluate_model(tmodel, loader)
        assert list(got) == list(want) == [f"{m}@{k}" for k in (20, 50, 100)
                                           for m in ("recall", "ndcg", "hitrate")]
        assert got == want
    assert trainer.evaluate_model(tmodel, loaders[2], topk_list=[5]).keys() == {
        "recall@5", "ndcg@5", "hitrate@5"}


def test_checkpoints_round_trip_both_ways(jax_sasrec, tmp_path, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    model, params, enc = jax_sasrec
    batch, _ = _batch(4)
    want = np.asarray(model.apply({"params": params}, batch, False)["user_emb"])
    # a JAX checkpoint served by the port
    path = str(tmp_path / "jax" / "model.ckpt")
    jax_save_checkpoint(path, params, None, enc_dict=enc, step=7)
    tmodel = get_model("SASRec")(enc_dict=enc, config=CONFIG)
    trainer = SequenceTrainer(device="cpu")
    assert trainer.load_model(tmodel, path)["enc_dict"] == enc
    assert trainer.step == 7
    np.testing.assert_allclose(_user_emb(tmodel, batch), want, rtol=0, atol=ATOL)
    # the port's checkpoint read by the JAX package
    out = trainer.save_all(tmodel, enc, str(tmp_path / "port"))
    ckpt = jax_load_checkpoint(out)
    assert ckpt["enc_dict"] == enc and ckpt["opt_state"] is None and ckpt["step"] == 7
    jax.tree_util.tree_map(np.testing.assert_array_equal, ckpt["params"], params)
    back = np.asarray(model.apply({"params": ckpt["params"]}, batch, False)["user_emb"])
    np.testing.assert_allclose(back, _user_emb(tmodel, batch), rtol=0, atol=ATOL)


def test_training_waits_for_the_training_slice(jax_sasrec, monkeypatch):
    """Training arrived with the training slice: the training batch, the
    loss and the dropout forward work; fit's mesh is ported too, and what
    raises is a mesh that is no DeviceMesh, beside the K-step option too."""
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    model, params, enc = jax_sasrec
    tmodel = _port(params, enc)
    batch, _ = _batch(5)
    batch["target_item"] = np.arange(1, B + 1, dtype=np.int32)
    with pytest.raises(TypeError, match="mesh must be a DeviceMesh"):
        SequenceTrainer(device="cpu").fit(tmodel, [batch], mesh=object())
    with pytest.raises(TypeError, match="mesh must be a DeviceMesh"):
        SequenceTrainer(device="cpu").fit(tmodel, [batch], steps_per_call=4, mesh=object())
    inputs = tmodel.upload_batch(batch, torch.device("cpu"), train=True)
    out = tmodel(inputs, train=True, seed=3)  # the default dropout rates are 0.1
    assert out["user_emb"].shape == (B, 8) and np.isfinite(float(out["loss"]))
    # the loss is the JAX model's full softmax CE of the same user embeddings
    want = model.apply({"params": params}, jnp.asarray(out["user_emb"].detach().numpy()),
                       jnp.asarray(batch["target_item"]), method="calculate_loss")
    got = tmodel.calculate_loss(out["user_emb"], inputs["target_item"])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(out["loss"]), float(got), rtol=0)


def test_item_table_and_corpus(jax_sasrec):
    model, params, enc = jax_sasrec
    tmodel = _port(params, enc)
    want = np.asarray(model.apply({"params": params}, method="output_items"))
    with torch.no_grad():
        got = tmodel.output_items().numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0].any()
    big = get_model("SASRec")(enc_dict={"item_id": {"vocab_size": 70_000}}, config=CONFIG)
    assert big.item_emb.table.shape == (73_728, 8)  # padded to 8192 rows, as in JAX
    assert big.output_items().shape == (70_000, 8)
    std = get_model("SASRec")(enc_dict=enc, config={**CONFIG, "emb_init_std": 0.01})
    assert float(std.item_emb.table.detach().std()) < 0.02


def test_attention_mask_and_gather_match_jax():
    from rec_pangu_tpu.models.base import SequenceModelBase as JaxSequenceModelBase
    from rec_pangu_tpu_torch.models import SequenceModelBase

    batch, lens = _batch(6)
    mask = batch["hist_mask_list"]
    np.testing.assert_array_equal(
        SequenceModelBase.get_attention_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(JaxSequenceModelBase.get_attention_mask(jnp.asarray(mask))))
    out = np.random.default_rng(6).standard_normal((B, L, 8)).astype(np.float32)
    idx = np.clip(lens - 1, 0, None).astype(np.int32)
    np.testing.assert_array_equal(
        SequenceModelBase.gather_indexes(torch.from_numpy(out), torch.from_numpy(idx)).numpy(),
        np.asarray(JaxSequenceModelBase.gather_indexes(jnp.asarray(out), jnp.asarray(idx))))


@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_helpers_match_jax(seed):
    from rec_pangu_tpu.eval import retrieval as jax_retrieval
    from rec_pangu_tpu_torch.eval import retrieval

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 30, (6, 40)).astype(np.int32)  # duplicates and item 0
    scores = np.round(rng.standard_normal(ids.shape), 1).astype(np.float32)  # ties
    got, got_n = retrieval.batched_merge_multi_interest_np(ids, scores, 12)
    want, want_n = jax_retrieval.batched_merge_multi_interest_np(ids, scores, 12)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_n, want_n)
    for i in range(len(ids)):
        assert (retrieval.merge_multi_interest(ids[i], scores[i], 12)
                == jax_retrieval.merge_multi_interest(ids[i], scores[i], 12)
                == got[i, :got_n[i]].tolist())
    preds = {str(u): rng.permutation(50)[:20].tolist() for u in range(30)}
    gd = {str(u): rng.integers(0, 50, rng.integers(1, 5)).tolist() for u in range(35)}
    for n in (5, 20):
        assert retrieval.evaluate_recall(preds, gd, n) == jax_retrieval.evaluate_recall(
            preds, gd, n)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    x[1] = 0.0  # a zero row stays zero
    np.testing.assert_allclose(retrieval.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_retrieval.l2_normalize(jnp.asarray(x))),
                               rtol=0, atol=1e-7)


class _MultiInterest(torch.nn.Module):
    """A stand-in multi-interest model: fixed [B, K, D] user embeddings."""

    def __init__(self, items, users):
        super().__init__()
        self.items = torch.nn.Parameter(torch.from_numpy(items))
        self.users = torch.from_numpy(users)

    def output_items(self):
        return self.items

    def upload_batch(self, batch, device):
        return {}

    def forward(self, inputs, train=False):
        return {"user_emb": self.users}


def test_multi_interest_retrieval():
    from rec_pangu_tpu.eval.retrieval import merge_multi_interest
    from rec_pangu_tpu_torch.eval.retrieval import get_recall_predict

    rng = np.random.default_rng(7)
    items = rng.standard_normal((40, 8)).astype(np.float32)
    users = rng.standard_normal((5, 3, 8)).astype(np.float32)
    model = _MultiInterest(items, users)
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)  # noqa: E731
    scores = np.einsum("bkd,nd->bkn", unit(users), unit(items))     # [B, K, V]
    batch = {"user": np.array([f"u{i}" for i in range(5)], dtype=object)}
    preds = get_recall_predict(model, [batch], topn=6)
    for i in range(5):  # each interest's top-6, merged as the reference merges
        top = np.argsort(-scores[i], axis=1, kind="stable")[:, :6]
        want = merge_multi_interest(top, np.take_along_axis(scores[i], top, 1), 6)
        assert preds[f"u{i}"] == want
    got_s, got_i = make_retrieval_scorer(model, topk=6, device="cpu")(batch)
    best = scores.max(axis=1)  # the scorer keeps each item's best interest
    np.testing.assert_array_equal(got_i, np.argsort(-best, axis=1, kind="stable")[:, :6])
    np.testing.assert_allclose(got_s, np.sort(best, axis=1)[:, ::-1][:, :6], rtol=0,
                               atol=1e-6)
