"""The port's data layer and metrics against the JAX package's, on the
bundled CSV fixtures: same enc_dict, arrays, loader batches and metric values."""
import dataclasses

import numpy as np
import pytest

import rec_pangu_tpu.data as jdata
import rec_pangu_tpu.eval.metrics as jmetrics
import rec_pangu_tpu_torch.data as tdata
import rec_pangu_tpu_torch.eval.metrics as tmetrics

from conftest import MULTITASK_SCHEMA, RANKING_SCHEMA, SEQ_SCHEMA


def _assert_batches_equal(jax_loader, torch_loader):
    jb, tb = list(jax_loader), list(torch_loader)
    assert len(jb) == len(tb) == len(torch_loader) == len(jax_loader)
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kind", ["ranking", "multitask"])
def test_get_dataloader_matches_jax(kind, ranking_df, multitask_df):
    df, schema = ((ranking_df, RANKING_SCHEMA) if kind == "ranking"
                  else (multitask_df, MULTITASK_SCHEMA))
    splits = (df[:70], df[:85], df[60:])
    j = jdata.get_dataloader(*splits, schema, batch_size=32)
    t = tdata.get_dataloader(*splits, schema, batch_size=32)
    assert t[3] == j[3]  # enc_dict, fit on the train split
    assert (dataclasses.astuple(tdata.FeatureSpec.from_enc_dict(t[3], schema))
            == dataclasses.astuple(jdata.FeatureSpec.from_enc_dict(j[3], schema)))
    for jl, tl in zip(j[:3], t[:3]):
        assert jl.dataset.arrays.keys() == tl.dataset.arrays.keys()
        for k, v in jl.dataset.arrays.items():
            assert tl.dataset.arrays[k].dtype == v.dtype
            np.testing.assert_array_equal(tl.dataset.arrays[k], v)
        _assert_batches_equal(jl, tl)
    # the shuffled train loader keeps the same order in its next epoch too
    _assert_batches_equal(j[0], t[0])


@pytest.mark.parametrize("schema", [RANKING_SCHEMA, MULTITASK_SCHEMA],
                         ids=["ranking", "multitask"])
def test_single_dataloader_with_oov_matches_jax(schema, multitask_df):
    enc_dict = jdata.fit_enc_dict(multitask_df[:40], schema)
    assert tdata.fit_enc_dict(multitask_df[:40], schema) == enc_dict
    j = jdata.get_single_dataloader(multitask_df[40:], schema, enc_dict, batch_size=16)
    t = tdata.get_single_dataloader(multitask_df[40:], schema, enc_dict, batch_size=16)
    sparse = t.dataset.arrays["sparse"]
    vocab = np.array([enc_dict[c]["vocab_size"] for c in t.dataset.spec.sparse_names])
    assert (sparse == vocab[None, :]).any(), "fixture split should hold OOV values"
    assert sparse.max() <= vocab.max()
    _assert_batches_equal(j, t)


def test_label_less_frame_encodes_like_jax(ranking_df):
    enc_dict = jdata.fit_enc_dict(ranking_df, RANKING_SCHEMA)
    unlabeled = ranking_df.drop(columns=[RANKING_SCHEMA["label_col"]])[:30]
    a = jdata.encode_ranking_df(unlabeled, enc_dict, RANKING_SCHEMA, ["click"])
    b = tdata.encode_ranking_df(unlabeled, enc_dict, RANKING_SCHEMA, ["click"])
    assert a.keys() == b.keys() == {"sparse", "dense"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_sequence_task_type_waits(ranking_df, seq_dfs):
    # the sequence datasets are ported now: task_type "sequence" routes to
    # them by protocol (tests/test_torch_sequence_data.py holds their arrays)
    for protocol, cls in (("v1", tdata.SequenceDataset), ("v2", tdata.SequenceDatasetV2)):
        loaders = tdata.get_dataloader(*seq_dfs, {**SEQ_SCHEMA, "protocol": protocol})
        assert [type(ld.dataset) for ld in loaders[:3]] == [cls] * 3
        assert [ld.dataset.phase for ld in loaders[:3]] == ["train", "valid", "test"]
        assert loaders[3] is loaders[0].dataset.enc_dict
    with pytest.raises(ValueError, match="task_type"):
        tdata.get_dataloader(ranking_df, ranking_df, ranking_df,
                             {**RANKING_SCHEMA, "task_type": "graph"})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 5000
    labels = (rng.random(n) < 0.3).astype(np.float32)
    # rounded scores force ties, which the AUC's averaged ranks must match
    preds = np.round(rng.random(n), 2).astype(np.float32)
    for fn in ("roc_auc_score", "log_loss"):
        a = getattr(jmetrics, fn)(labels, preds)
        b = getattr(tmetrics, fn)(labels, preds)
        assert abs(a - b) <= 1e-12
    assert (tmetrics.compute_ranking_metrics(labels, preds, prefix="train_")
            == jmetrics.compute_ranking_metrics(labels, preds, prefix="train_"))
    labels2 = (rng.random((n, 2)) < 0.5).astype(np.float32)
    preds2 = rng.random((n, 2)).astype(np.float32)
    assert (tmetrics.compute_ranking_metrics(labels2, preds2, prefix="test_", num_task=2)
            == jmetrics.compute_ranking_metrics(labels2, preds2, prefix="test_",
                                                num_task=2))
