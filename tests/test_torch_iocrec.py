"""IOCRec served and trained by the port against the JAX package's IOCRec.

Weights are made by the JAX package and carried across; batches from a numpy
seed, the augmented views ``aug_all`` made on the host and given to both.
Tolerances, float32 on both sides summed in other orders:

* ``user_emb`` [B, K, D] within atol 1e-5 of the JAX model's, on its flax
  path and with its Pallas encoders in interpret mode;
* the training loss (dropout 0) within rtol 1e-5 and every gradient within
  rtol 1e-5 and an atol of 1e-5 times its largest entry (at least 1e-6); the
  key biases of both encoders and ``layer_norm_2``'s bias have an exact
  gradient of 0 (a softmax does not change when a row of scores moves by one
  constant), so both sides hold rounding noise there, held within 1e-5 of 0;
* the sequence fused step (history rows of the [3B, L] lookup and the K-max
  CE's dense item gradient into one table Adam pass) against the JAX
  standard step: parameters after one step within atol 1e-6 (those zero
  gradients, whose noise Adam's first step turns into +-lr, within 2 lr), losses over
  three steps within rtol 1e-5;
* retrieval metrics on the bundled data equal to the JAX trainer's (both
  round to 4 dp).
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.models.sequence.contrarec import (
    host_augment_sequences as jax_host_augment_sequences)
from rec_pangu_tpu.models.sequence.iocrec import info_nce_loss as jax_info_nce_loss
from rec_pangu_tpu.train import SequenceTrainer as JaxSequenceTrainer
from rec_pangu_tpu.train.ckpt import load_checkpoint as jax_load_checkpoint
from rec_pangu_tpu.train.optim import make_optimizer as jax_make_optimizer
from rec_pangu_tpu.train.steps import TrainState, make_train_step
from rec_pangu_tpu_torch.convert import jax_tree, jax_variables, load_jax_variables
from rec_pangu_tpu_torch.data import get_dataloader
from rec_pangu_tpu_torch.eval.retrieval import l2_normalize
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.models.sequence.augment import (augment_sequences,
                                                          host_augment_sequences)
from rec_pangu_tpu_torch.models.sequence.iocrec import info_nce_loss
from rec_pangu_tpu_torch.serving import make_retrieval_scorer
from rec_pangu_tpu_torch.train import SequenceTrainer
from rec_pangu_tpu_torch.train import fused_update
from rec_pangu_tpu_torch.train.fused_update import SeqFusedStep, maybe_enable_seq_fused_update

from conftest import SEQ_SCHEMA

B, L, VOCAB, K, D, LR = 16, 12, 200, 3, 8, 1e-3
CONFIG = {"embedding_dim": D, "max_length": L, "K": K, "num_blocks": 1, "num_heads": 2,
          "ffn_hidden": 16, "hidden_dropout": 0.0, "attn_dropout": 0.0, "item_col": "item_id"}
ENC = {"item_id": {"vocab_size": VOCAB}}
# exact gradients of 0: the encoders' key biases, and layer_norm_2's bias
# (it moves every intention's logit of an item by one constant)
ZERO_GRAD = ("['key']['bias']", "['K_linear']['bias']", "['layer_norm_2']['bias']")


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _batch(seed, train=True):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, B)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    hist = np.where(mask > 0, rng.integers(1, VOCAB, (B, L)), 0).astype(np.int32)
    batch = {"hist_item_list": hist, "hist_mask_list": mask}
    if train:
        batch["target_item"] = rng.integers(1, VOCAB, B).astype(np.int32)
        views = [host_augment_sequences(rng, hist, 3.0, 3.0, VOCAB - 1) for _ in range(2)]
        batch["aug_all"] = np.concatenate([hist] + views)
    return batch


@pytest.fixture(scope="module")
def jax_iocrec():
    model = jax_get_model("IOCRec")(enc_dict=ENC, config=CONFIG)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    variables = jax.jit(lambda r, b: model.init(r, b, False))(rngs, _batch(0, train=False))
    params = _numpy(variables["params"])
    rng = np.random.default_rng(5)  # nonzero biases, so that every term counts
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if jax.tree_util.keystr(p).endswith("['bias']") else a, params)
    return model, params


def _port(params, config=CONFIG, enc=ENC):
    model = get_model("IOCRec")(enc_dict=enc, config=config)
    load_jax_variables(model, {"params": params})
    return model


def _user_emb(model, batch):
    with torch.no_grad():
        return model.eval()(model.upload_batch(batch, torch.device("cpu")))["user_emb"].numpy()


@pytest.mark.parametrize("path", ["flax", "pallas_interpret"])
def test_user_emb_matches_jax(path, jax_iocrec, monkeypatch):
    if path == "flax":
        monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    else:
        monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "1")
    model, params = jax_iocrec
    batch = _batch(1, train=False)
    want = np.asarray(jax.jit(lambda p, b: model.apply({"params": p}, b, False))(
        params, batch)["user_emb"])
    got = _user_emb(_port(params), batch)
    assert got.shape == (B, K, D)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_factored_form_equals_the_dense_layer_norm(jax_iocrec):
    _, params = jax_iocrec
    model = _port(params)
    enc = model.disentangle_encoder
    rng = np.random.default_rng(2)
    local, glob = (torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))
                   for _ in range(2))
    seq_len = torch.from_numpy(rng.integers(1, L + 1, B))
    with torch.no_grad():
        factors = enc(local, glob, seq_len)
        dense = factors.dense()
        # the reference: layer_norm_5 of each intention's score times the rows
        want = 0
        for e in (local, glob):
            logits = torch.einsum("bld,kd->blk", enc.layer_norm_1(e),
                                  enc.layer_norm_2(enc.intentions))
            i2i = torch.softmax(logits / D ** 0.5, dim=-1)
            idx = (seq_len - 1).clamp(0, L - 1)
            q = enc.layer_norm_3(e[torch.arange(B), idx] + enc.pos_fai[idx] + enc.rou)
            key_hat = enc.layer_norm_4(e + enc.pos_fai[:L])
            key = key_hat + torch.relu(enc.W(key_hat))
            attn = torch.softmax(torch.einsum("bd,bmd->bm", q, key) / D ** 0.5, dim=-1)
            s = (i2i * attn[..., None]).transpose(1, 2)
            want = want + enc.layer_norm_5(s[..., None] * e[:, None])
        idx = (seq_len - 1).clamp(0, L - 1)
        gathered = factors.gather_user_emb(idx)
    torch.testing.assert_close(dense, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gathered, dense[torch.arange(B), :, idx], rtol=1e-6, atol=1e-6)


def test_info_nce_matches_jax():
    rng = np.random.default_rng(3)
    v1, v2 = (rng.standard_normal((12, 5, 4)).astype(np.float32) for _ in range(2))
    want = float(jax_info_nce_loss(jnp.asarray(v1), jnp.asarray(v2), 2.0))
    got = float(info_nce_loss(torch.from_numpy(v1), torch.from_numpy(v2), 2.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _assert_tree_close(got, want, atol_of, key_bias_atol=None):
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(flat_want)
    for path, arr in flat_got:
        name = jax.tree_util.keystr(path)
        ref = np.asarray(flat_want[path])
        if any(k in name for k in ZERO_GRAD):
            if key_bias_atol is None:  # an exact gradient of 0: noise on both sides
                assert max(np.abs(arr).max(), np.abs(ref).max()) < 1e-5, name
            else:
                np.testing.assert_allclose(arr, ref, rtol=0, atol=key_bias_atol, err_msg=name)
            continue
        np.testing.assert_allclose(arr, ref, rtol=1e-5 if key_bias_atol is None else 0,
                                   atol=atol_of(ref), err_msg=name)


@pytest.mark.parametrize("fused_ce", ["auto", "1"])
def test_training_loss_and_gradients_match_jax(fused_ce, jax_iocrec, monkeypatch):
    """fused_ce auto: the naive [B, K, V] CE on both sides (200 items); 1:
    the JAX scan against the port's K5 plain versions."""
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_CE", fused_ce)
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    jmodel, params = jax_iocrec
    batch = _batch(4)

    def loss(p):
        return jmodel.apply({"params": p}, batch, True,
                            rngs={"dropout": jax.random.PRNGKey(2)})["loss"]

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(params)
    model = _port(params).train()
    out = model(model.upload_batch(batch, torch.device("cpu"), train=True), train=True, seed=1)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(want_loss), rtol=1e-5)
    got = jax_tree(model, lambda t: t.grad)
    _assert_tree_close(got, _numpy(want_grads),
                       lambda ref: 1e-5 * max(0.1, float(np.abs(ref).max())))


def test_host_augmentation_and_the_trainer_views_match_jax(jax_iocrec):
    hist = _batch(5, train=False)["hist_item_list"]
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):
        np.testing.assert_array_equal(host_augment_sequences(a, hist, 3.0, 3.0, VOCAB - 1),
                                      jax_host_augment_sequences(b, hist, 3.0, 3.0, VOCAB - 1))
    # the trainers: two training batches through each one's own generator
    jmodel, params = jax_iocrec
    jtrainer = JaxSequenceTrainer()
    jtrainer.model = jmodel
    trainer = SequenceTrainer(device="cpu")
    trainer.model = _port(params)
    for seed in (6, 7):
        batch = {k: v for k, v in _batch(seed).items() if k != "aug_all"}
        want = jtrainer._attach_plan(dict(batch))["aug_all"]
        got = trainer._attach_aug(batch)["aug_all"]
        assert got.shape == (3 * B, L)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:B], batch["hist_item_list"])


def test_device_augmentation_draws_from_the_step_seed(jax_iocrec):
    _, params = jax_iocrec
    model = _port(params).train()
    batch = {k: v for k, v in _batch(8).items() if k != "aug_all"}
    inputs = model.upload_batch(batch, torch.device("cpu"), train=True)
    a, b, c = (float(model(inputs, train=True, seed=s)["loss"].detach()) for s in (3, 3, 4))
    assert a == b and a != c
    hist = torch.from_numpy(np.tile(np.arange(1, 51, dtype=np.int64), (2000, 1)))
    views = augment_sequences(torch.Generator().manual_seed(0), hist, 3.0, 3.0, 999)
    masked = (views == 999).any(dim=1)
    # a reordered view keeps the history's items; a masked one keeps its order
    assert torch.equal(views[~masked].sort(dim=1).values, hist[~masked])
    kept = views[masked]
    assert torch.all((kept == 999) | (kept == hist[masked]))
    assert abs(float(masked.float().mean()) - 0.5) < 0.05
    assert abs(float((kept == 999).float().mean()) - 0.5) < 0.05  # Beta(3, 3) has mean 1/2


@pytest.fixture(scope="module")
def jax_standard_run(jax_iocrec):
    """Three JAX standard steps (flax encoders, naive CE) from the same weights."""
    os.environ["REC_PANGU_TPU_FUSED_ENCODER"] = "0"
    try:
        jmodel, params = jax_iocrec
        batches = [_batch(s) for s in (10, 11, 12)]
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
    finally:
        del os.environ["REC_PANGU_TPU_FUSED_ENCODER"]
    return {"after_one": after_one, "losses": losses, "batches": batches}


def test_fused_steps_match_jax_standard_step(jax_iocrec, jax_standard_run, monkeypatch):
    j = jax_standard_run
    model = _port(jax_iocrec[1]).train()
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
        out = step(model.upload_batch(batch, torch.device("cpu"), train=True), i)
        losses.append(float(out["loss"].detach()))
        after_one = after_one or jax_variables(model)["params"]
    # K3's ids are the [3B, L] lookup's: aug_all, not the histories
    ids, rows_shape, dense_shape = launches[0]
    np.testing.assert_array_equal(ids.numpy(), j["batches"][0]["aug_all"].reshape(-1))
    assert rows_shape == (3 * B * L, D) and dense_shape == (VOCAB, D)
    _assert_tree_close(after_one, j["after_one"], lambda ref: 1e-6, key_bias_atol=2 * LR)
    np.testing.assert_allclose(losses, j["losses"], rtol=1e-5)
    assert step.opt_state(3)["tables"]["item_emb/table"]["mu"].shape == (VOCAB, D)


def test_scorer_scores_are_the_max_over_interests(jax_iocrec):
    model = _port(jax_iocrec[1])
    batch = _batch(13, train=False)
    scores, ids = make_retrieval_scorer(model, topk=20, device="cpu")(batch)
    with torch.no_grad():
        u = l2_normalize(model(model.upload_batch(batch, torch.device("cpu")))["user_emb"])
        full = torch.einsum("bkd,nd->bkn", u, l2_normalize(model.output_items())).amax(dim=1)
        want_s, want_i = torch.topk(full, 20, dim=-1)
    np.testing.assert_array_equal(scores, want_s.numpy())
    np.testing.assert_array_equal(ids, want_i.numpy())


def _bundled(seq_dfs, batch_size=64):
    schema = {**SEQ_SCHEMA, "max_length": 20}
    loaders = get_dataloader(*seq_dfs, schema, batch_size=batch_size)
    config = {"embedding_dim": 16, "max_length": 20, "K": 2, "num_blocks": 1,
              "ffn_hidden": 32, "hidden_dropout": 0.1, "attn_dropout": 0.1}
    return loaders, config


def test_evaluate_model_matches_jax_on_bundled_data(seq_dfs, tmp_path, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    loaders, config = _bundled(seq_dfs, batch_size=1024)
    enc = loaders[3]
    jmodel = jax_get_model("IOCRec")(enc_dict=enc, config=config)
    sample = {k: v for k, v in next(iter(loaders[2])).items() if k.startswith("hist_")}
    jtrainer = JaxSequenceTrainer(model_ckpt_dir=str(tmp_path))
    rngs = {"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)}
    params = jax.jit(lambda r, b: jmodel.init(r, b, False))(rngs, sample)["params"]
    tx = jax_make_optimizer(1e-3, 1)
    jtrainer.state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=None,
                                opt_state=tx.init(params), apply_fn=jmodel.apply, tx=tx)
    jtrainer.model, jtrainer._has_bs = jmodel, False
    model = _port(_numpy(jtrainer.state.params), config, enc)
    trainer = SequenceTrainer(device="cpu")
    want = jtrainer.evaluate_model(jmodel, loaders[2])
    got = trainer.evaluate_model(model, loaders[2])
    assert list(got) == [f"{m}@{k}" for k in (20, 50, 100) for m in ("recall", "ndcg", "hitrate")]
    assert got == want


def test_fit_on_bundled_data_and_checkpoints(seq_dfs, tmp_path):
    loaders, config = _bundled(seq_dfs, batch_size=128)
    enc = loaders[3]
    model = get_model("IOCRec")(enc_dict=enc, config=config)
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
    trainer.fit(model, loaders[0], loaders[1], epoch=epochs, lr=5e-3, use_earlystopping=True,
                max_patience=epochs, monitor_metric="recall@20", seed=3)
    assert isinstance(trainer._train_step, SeqFusedStep) and trainer._aug_rng is not None
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
    reloaded = get_model("IOCRec")(enc_dict=enc, config=config)
    SequenceTrainer(device="cpu").load_model(reloaded, path)
    np.testing.assert_array_equal(_user_emb(reloaded, batch), want)
    os.environ["REC_PANGU_TPU_FUSED_ENCODER"] = "0"
    try:
        jmodel = jax_get_model("IOCRec")(enc_dict=enc, config=config)
        jax_emb = np.asarray(jax.jit(lambda p, b: jmodel.apply({"params": p}, b, False))(
            ckpt["params"], batch)["user_emb"])
    finally:
        del os.environ["REC_PANGU_TPU_FUSED_ENCODER"]
    np.testing.assert_allclose(want, jax_emb, rtol=0, atol=1e-5)
