"""The rest of ``fit``'s single-device arguments on the port, and the
trainer utilities, against the JAX package's behaviour.

* ``resume_from``: a run of 2 + 2 epochs from a port checkpoint equals the
  uninterrupted 4 (AFN: two tables, BatchNorm statistics, dropout on, a
  StepLR schedule), on the fused and the standard step, with float32 and
  bfloat16 table moments: every weight, statistic and moment within 1e-6
  (the same steps from the same state: in practice the same bits).  A
  checkpoint written by the JAX trainer's ``save_all`` resumes with its
  Adam moments and reaches the JAX package's uninterrupted weights within
  2e-6 (float32 products summed in other orders, over three more Adam steps
  at lr 1e-3).
* ``steps_per_call=2`` (and 3) trains to the bits of 1 (DeepFM fused and
  standard, GRU4Rec standard and sequence-fused, CMI with its projection).
* ``profile_dir`` writes a Chrome trace.
* Pretrained rows: frozen ones keep their bits for 3 epochs, trainable
  ones move.  ``BenchmarkTrainer``'s columns; wandb's per-batch losses;
  ``seed_everything``, ``beautify_json``, ``get_device_usage``.
"""
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from rec_pangu_tpu.data import DataLoader as JaxDataLoader
from rec_pangu_tpu.data import RankingDataset as JaxRankingDataset
from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.train import RankTrainer as JaxRankTrainer
from rec_pangu_tpu.train.ckpt import save_checkpoint as jax_save_checkpoint
from rec_pangu_tpu.train.fused_update import init_fused_opt_state
from rec_pangu_tpu_torch.convert import jax_variables
from rec_pangu_tpu_torch.data import DataLoader, RankingDataset, get_dataloader
from rec_pangu_tpu_torch.data.encoder import FeatureSpec
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.train import BenchmarkTrainer, RankTrainer, SequenceTrainer
from rec_pangu_tpu_torch.train.ckpt import load_checkpoint, read_opt_state
from rec_pangu_tpu_torch.train.fused_update import FusedStep
from rec_pangu_tpu_torch.train.steps import StandardStep
from rec_pangu_tpu_torch.utils import beautify_json, get_device_usage, seed_everything

from conftest import MULTITASK_SCHEMA, RANKING_SCHEMA, SEQ_SCHEMA

CPU = torch.device("cpu")
AFN_KW = {"embedding_dim": 8, "dnn_hidden_units": (16,), "afn_hidden_units": (16,),
          "logarithmic_neurons": 4}
SCHED = {"lr_scheduler_type": "StepLR", "scheduler_params": {"step_size": 1, "gamma": 0.7}}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _assert_trees_close(got, want, atol):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, str) or v is None:
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(v, np.float64),
                                       rtol=0, atol=atol, err_msg="/".join(map(str, k)))


def _afn_run(ds, enc, ckpt_dir, epochs, resume_from=None, model_seed=3):
    model = get_model("AFN")(enc_dict=enc, seed=model_seed, **AFN_KW)
    trainer = RankTrainer(model_ckpt_dir=str(ckpt_dir), device="cpu")
    trainer.fit(model, DataLoader(ds, batch_size=32), None, epoch=epochs, lr=1e-2, seed=42,
                resume_from=resume_from, **SCHED)
    return model, trainer


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("step", ["fused", "standard"])
def test_resume_equals_the_uninterrupted_run(ranking_df, tmp_path, monkeypatch, step, moments):
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ADAM", "1" if step == "fused" else "0")
    monkeypatch.setenv("REC_PANGU_TPU_MOMENT_DTYPE", moments)
    ds = RankingDataset(RANKING_SCHEMA, ranking_df)  # 100 rows: 3 batches of 32 and one of 4
    full_model, full = _afn_run(ds, ds.enc_dict, tmp_path / "full", 4)
    assert full._train_step.fused == (step == "fused") and full.step == 16
    _, first = _afn_run(ds, ds.enc_dict, tmp_path / "a", 2)
    path = first.save_all(first.model, ds.enc_dict, str(tmp_path / "a"))
    model, resumed = _afn_run(ds, ds.enc_dict, tmp_path / "b", 2, resume_from=path,
                              model_seed=99)
    assert resumed.step == 16 and resumed._train_step.fused == (step == "fused")
    _assert_trees_close(jax_variables(model), jax_variables(full_model), 1e-6)
    got, want = resumed._opt_state(), full._opt_state()
    if step == "fused":
        assert set(want["tables"]) == {"FusedEmbedding_0/table", "embedding2/table"}
        assert {t["dtype"] for t in want["tables"].values()} == {
            "bfloat16" if moments == "bf16" else "float32"}
    _assert_trees_close(got, want, 1e-6)


def test_table_moments_cross_steps(ranking_df):
    """The fused step's table moments load into the standard step's Adam
    state, and back: each step reads the other's checkpoint exactly."""
    ds = RankingDataset(RANKING_SCHEMA, ranking_df[:64])
    model = get_model("AFN")(enc_dict=ds.enc_dict, seed=3, **AFN_KW)
    fused = FusedStep(model, 1e-2, 1, generator=torch.Generator().manual_seed(0))
    fused(model.upload_batch(next(iter(DataLoader(ds, batch_size=64))), CPU, train=True), 0)
    state = fused.opt_state(1)
    std = StandardStep(model, 1e-2, 1)
    std.load_opt_state(state)
    for (_, m), (mu, nu) in zip(fused.tables, fused.moments):
        adam = std.optimizer.state[m.table]
        assert torch.equal(adam["exp_avg"], mu) and torch.equal(adam["exp_avg_sq"], nu)
        assert float(adam["step"]) == 1.0
    back = FusedStep(model, 1e-2, 1)
    back.load_opt_state(std.opt_state(1))
    for (mu, nu), (mu2, nu2) in zip(fused.moments, back.moments):
        assert torch.equal(mu, mu2) and torch.equal(nu, nu2)


def test_resume_from_a_jax_checkpoint(ranking_df, tmp_path):
    ds = JaxRankingDataset(RANKING_SCHEMA, ranking_df[:80])
    enc = ds.enc_dict

    def jax_fit(epochs, tag):
        model = jax_get_model("DeepFM")(enc_dict=enc, embedding_dim=8, hidden_units=(16,))
        trainer = JaxRankTrainer(num_task=1, model_ckpt_dir=str(tmp_path / tag))
        trainer.fit(model, JaxDataLoader(ds, batch_size=80), None, epoch=epochs, lr=1e-3,
                    seed=42)
        return trainer

    full = jax_fit(6, "full")
    half = jax_fit(3, "half")
    half.save_all(half.model, enc, str(tmp_path / "half"))
    path = str(tmp_path / "half" / "model.ckpt")
    saved = load_checkpoint(path)
    state = read_opt_state(saved["opt_state"], saved["step"])
    assert state is not None and state["step"] == 3

    model = get_model("DeepFM")(enc_dict=enc, embedding_dim=8, hidden_units=(16,), seed=5)
    trainer = RankTrainer(model_ckpt_dir=str(tmp_path / "port"), device="cpu")
    trainer.fit(model, DataLoader(RankingDataset(RANKING_SCHEMA, ranking_df[:80], enc_dict=enc),
                                  batch_size=80), None, epoch=0, lr=1e-3, seed=42,
                resume_from=path)
    assert trainer.step == 3 and trainer._train_step.fused
    mu = trainer._train_step.moments[0][0].numpy()
    np.testing.assert_array_equal(
        mu, np.asarray(state["params"]["mu"]["FusedEmbedding_0"]["table"]))
    assert np.abs(mu).max() > 0
    trainer.fit(model, DataLoader(RankingDataset(RANKING_SCHEMA, ranking_df[:80], enc_dict=enc),
                                  batch_size=80), None, epoch=3, lr=1e-3, seed=42,
                resume_from=path)
    assert trainer.step == 6
    _assert_trees_close(jax_variables(model)["params"],
                        jax.tree_util.tree_map(np.asarray, full.state.params), 2e-6)


def test_reading_the_jax_fused_and_unknown_states(tmp_path):
    """The JAX fused step's masked Adam and table moments read into the
    layout; an optimizer state of another kind restores params only."""
    import optax

    params = {"FusedEmbedding_0": {"table": np.ones((6, 4), np.float32)},
              "Dense_0": {"kernel": np.full((4, 2), 2.0, np.float32)}}
    _, opt_state = init_fused_opt_state(params, {("FusedEmbedding_0", "table"): 4}, 1e-3, 1)
    jax_save_checkpoint(str(tmp_path / "fused.ckpt"), params, opt_state=opt_state, step=7)
    state = read_opt_state(load_checkpoint(str(tmp_path / "fused.ckpt"))["opt_state"], 7)
    assert state["step"] == 7
    assert set(_flat(state["params"]["mu"])) == {("Dense_0", "kernel")}
    assert set(state["tables"]) == {"FusedEmbedding_0/table"}
    assert state["tables"]["FusedEmbedding_0/table"]["mu"].shape == (6, 4)

    jax_save_checkpoint(str(tmp_path / "sgd.ckpt"), params,
                        opt_state=optax.sgd(0.1).init(params), step=2)
    assert read_opt_state(load_checkpoint(str(tmp_path / "sgd.ckpt"))["opt_state"], 2) is None


def test_unknown_optimizer_state_restores_params_only(ranking_df, tmp_path, caplog):
    ds = RankingDataset(RANKING_SCHEMA, ranking_df[:64])
    model = get_model("DeepFM")(enc_dict=ds.enc_dict, embedding_dim=8, hidden_units=(16,))
    weights = jax_variables(model)
    path = str(tmp_path / "odd.ckpt")
    with open(path, "wb") as f:
        pickle.dump({**weights, "opt_state": {"something": np.zeros(3)}, "step": 4}, f)
    fresh = get_model("DeepFM")(enc_dict=ds.enc_dict, embedding_dim=8, hidden_units=(16,),
                                seed=9)
    trainer = RankTrainer(model_ckpt_dir=str(tmp_path), device="cpu")
    with caplog.at_level("WARNING", logger="rec_pangu_tpu_torch"):
        trainer.fit(fresh, DataLoader(ds, batch_size=64), epoch=0, resume_from=path)
    assert "restoring params only" in caplog.text and trainer.step == 4
    _assert_trees_close(jax_variables(fresh), weights, 0)
    assert all(float(mu.abs().max()) == 0 for mu, _ in trainer._train_step.moments)


def _rank_fit(ds, k, tmp_path, **kw):
    model = get_model("DeepFM")(enc_dict=ds.enc_dict, embedding_dim=8, hidden_units=(16,))
    trainer = RankTrainer(model_ckpt_dir=str(tmp_path / f"k{k}"), device="cpu")
    metric = trainer.fit(model, DataLoader(ds, batch_size=24, shuffle=True, seed=5), None,
                         epoch=2, lr=1e-2, seed=9, steps_per_call=k, **kw)
    return model, trainer, metric


@pytest.mark.parametrize("step", ["fused", "standard"])
def test_rank_steps_per_call_gives_the_same_bits(ranking_df, tmp_path, monkeypatch, step):
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ADAM", "1" if step == "fused" else "0")
    ds = RankingDataset(RANKING_SCHEMA, ranking_df)  # 100 rows: 4 batches of 24 and one of 4
    m1, t1, metric1 = _rank_fit(ds, 1, tmp_path)
    m2, t2, metric2 = _rank_fit(ds, 2, tmp_path)
    assert t2._train_step.fused == (step == "fused") and t1.step == t2.step == 10
    assert metric1 == metric2
    for (name, a), (_, b) in zip(m1.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, b), name
    _, t3, metric3 = _rank_fit(ds, 3, tmp_path)
    assert metric3 == metric1 and t3.step == 10


def _seq_fit(name, config, k, tmp_path, seq_dfs):
    loaders = get_dataloader(*seq_dfs, {**SEQ_SCHEMA, "max_length": 20}, batch_size=64)
    model = get_model(name)(enc_dict=loaders[3], config=config)
    trainer = SequenceTrainer(model_ckpt_dir=str(tmp_path / f"{name}{k}"), device="cpu")
    trainer.fit(model, loaders[0], None, epoch=1, lr=1e-2, seed=9, steps_per_call=k)
    return model, trainer


@pytest.mark.parametrize("case", ["GRU4Rec-standard", "GRU4Rec-fused", "CMI"])
def test_sequence_steps_per_call_gives_the_same_bits(seq_dfs, tmp_path, monkeypatch, case):
    name = case.split("-")[0]
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ADAM", "0" if case.endswith("standard") else "1")
    config = {"embedding_dim": 16, "max_length": 20}
    if name == "CMI":
        config.update({"K": 4, "num_layers": 1, "dropout_prob": 0.1})
    m1, t1 = _seq_fit(name, config, 1, tmp_path, seq_dfs)
    m2, t2 = _seq_fit(name, config, 2, tmp_path, seq_dfs)
    assert t2._train_step.fused == (not case.endswith("standard"))
    assert t1.step == t2.step > 2
    for (key, a), (_, b) in zip(m1.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, b), key


def test_profile_dir_writes_a_trace(ranking_df, tmp_path):
    ds = RankingDataset(RANKING_SCHEMA, ranking_df[:96])
    model = get_model("DeepFM")(enc_dict=ds.enc_dict, embedding_dim=8, hidden_units=(16,))
    trainer = RankTrainer(model_ckpt_dir=str(tmp_path), device="cpu")
    trainer.fit(model, DataLoader(ds, batch_size=48), epoch=2,
                profile_dir=str(tmp_path / "trace"))
    assert os.path.dirname(trainer.trace_path) == str(tmp_path / "trace")
    assert os.listdir(tmp_path / "trace") == [os.path.basename(trainer.trace_path)]
    with open(trainer.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_frozen_pretrained_rows_keep_their_bits(ranking_df, tmp_path):
    ds = RankingDataset(RANKING_SCHEMA, ranking_df[:80])
    enc = ds.enc_dict
    dim = 8
    cities = [v for v in enc["city"] if v != "vocab_size"][:3]
    pre = {c: np.full(dim, 0.5, np.float32) + i for i, c in enumerate(cities)}
    rows = FeatureSpec.from_enc_dict(enc).feature_slice("city")
    tables = {}
    for trainable in (False, True):
        model = get_model("WDL")(enc_dict=enc, embedding_dim=dim)
        trainer = RankTrainer(model_ckpt_dir=str(tmp_path), device="cpu")
        trainer.set_pretrained_weights(model, "city", pre, trainable=trainable)
        trainer.fit(model, DataLoader(ds, batch_size=80), None, epoch=3, lr=1e-2)
        assert not trainer._train_step.fused  # K3 would move every row
        tables[trainable] = model.embedding.table.detach()[rows].numpy()
    for i, c in enumerate(cities):
        want = np.full(dim, 0.5, np.float32) + i
        np.testing.assert_array_equal(tables[False][enc["city"][c]], want)
        assert np.abs(tables[True][enc["city"][c]] - want).max() > 1e-4


def test_benchmark_trainer_columns(ranking_df, multitask_df, tmp_path):
    loaders = get_dataloader(ranking_df[:80], ranking_df[:90], ranking_df[:95],
                             RANKING_SCHEMA, batch_size=512)
    bt = BenchmarkTrainer(["LR", "FM"], model_ckpt_dir=str(tmp_path / "ckpt"),
                          benchmark_res_path=str(tmp_path / "res.csv"))
    df = bt.run(*loaders, epoch=2, device="cpu", model_kwargs={"FM": {"embedding_dim": 8}})
    assert list(df["model_name"]) == ["LR", "FM"]
    assert {"model_name", "train_model_time(ms)", "test_model_time(ms)", "examples_per_s",
            "valid_roc_auc_score", "test_log_loss"} <= set(df.columns)
    assert (tmp_path / "res.csv").exists()

    loaders = get_dataloader(multitask_df[:200], multitask_df[:200], multitask_df[:200],
                             MULTITASK_SCHEMA, batch_size=512)
    bt = BenchmarkTrainer(["ShareBottom"], num_task=2, model_ckpt_dir=str(tmp_path / "mt"),
                          benchmark_res_path=str(tmp_path / "mt.csv"))
    df = bt.run(*loaders, epoch=1, device="cpu")
    assert {"valid_test_task1_roc_auc_score", "test_test_task2_roc_auc_score"} <= set(df.columns)


def test_per_batch_wandb_loss_logging(ranking_df, tmp_path, monkeypatch):
    import rec_pangu_tpu_torch.train.trainer as trainer_mod

    logged = []

    class _Rec:
        def init(self, **kwargs):
            logged.append(("init", kwargs))

        def login(self, key):
            logged.append(("login", key))

        def log(self, d):
            logged.append(dict(d))

    monkeypatch.setattr(trainer_mod, "wandb", _Rec())
    loader = get_dataloader(ranking_df, ranking_df, ranking_df, RANKING_SCHEMA,
                            batch_size=32)[0]
    model = get_model("LR")(enc_dict=loader.dataset.enc_dict)
    trainer = RankTrainer(model_ckpt_dir=str(tmp_path), device="cpu",
                          wandb_config={"key": "k", "project": "p"})
    trainer.use_wandb = True
    trainer.fit(model, loader, epoch=1, log_rounds=1)
    assert logged[:2] == [("login", "k"), ("init", {"project": "p"})]
    assert len([d for d in logged if isinstance(d, dict) and set(d) == {"loss"}]) == len(loader)


def test_utils():
    seed_everything(5)
    a = (np.random.rand(), torch.rand(1))
    seed_everything(5)
    assert (np.random.rand(), torch.rand(1))[0] == a[0] and os.environ["PYTHONHASHSEED"] == "5"
    assert beautify_json({"a": 1, "b": [1, 2], "c": np.float32(0.5)}) == json.dumps(
        {"a": 1, "b": [1, 2], "c": "0.5"}, indent=4)
    assert get_device_usage("cpu") == "n/a"
