"""The port's sequence datasets and loaders against the JAX package's, on the
bundled MovieLens sample (``conftest.seq_dfs``): the same seed gives the same
window arrays, ground truth and batches, bit for bit."""
import numpy as np
import pytest

from rec_pangu_tpu.data import encoder as jax_encoder
from rec_pangu_tpu.data import get_dataloader as jax_get_dataloader
from rec_pangu_tpu.data import sequence as jax_sequence
from rec_pangu_tpu_torch.data import encoder, get_dataloader, sequence

from conftest import SEQ_SCHEMA

PHASES = ("train", "valid", "test")


def _assert_same_arrays(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("cls", ["SequenceDataset", "SequenceDatasetV2"])
@pytest.mark.parametrize("phase", PHASES)
def test_dataset_equals_jax(seq_dfs, cls, phase):
    df = seq_dfs[PHASES.index(phase)]
    enc = jax_encoder.fit_sequence_enc_dict(seq_dfs[0], SEQ_SCHEMA)
    want = getattr(jax_sequence, cls)(SEQ_SCHEMA, df, enc_dict=enc, phase=phase, seed=11)
    got = getattr(sequence, cls)(SEQ_SCHEMA, df, enc_dict=enc, phase=phase, seed=11)
    assert len(got) == len(want)
    assert got.item_vocab_size == want.item_vocab_size
    _assert_same_arrays(got.arrays, want.arrays)
    assert got.get_test_gd() == want.get_test_gd()
    if phase == "train":  # a new epoch draws new split points from the same stream
        want.resample(1)
        got.resample(1)
        _assert_same_arrays(got.arrays, want.arrays)


def test_fit_sequence_enc_dict_equals_jax(seq_dfs):
    want = jax_encoder.fit_sequence_enc_dict(seq_dfs[0], SEQ_SCHEMA)
    got = encoder.fit_sequence_enc_dict(seq_dfs[0], SEQ_SCHEMA)
    assert got == want
    assert min(v for k, v in got["item_id"].items() if k != "vocab_size") == 1


@pytest.mark.parametrize("protocol", ["v1", "v2"])
def test_loaders_equal_jax_over_two_epochs(seq_dfs, protocol):
    schema = {**SEQ_SCHEMA, "protocol": protocol}
    want = jax_get_dataloader(*seq_dfs, schema, batch_size=128)
    got = get_dataloader(*seq_dfs, schema, batch_size=128)
    assert got[3] == want[3]
    for g_loader, w_loader in zip(got[:3], want[:3]):
        assert len(g_loader) == len(w_loader)
        epochs = 2 if g_loader.shuffle else 1
        for _ in range(epochs):  # the train loader resamples its windows each epoch
            pairs = list(zip(g_loader, w_loader, strict=True))
            for g_batch, w_batch in pairs:
                _assert_same_arrays(g_batch, w_batch)


def test_train_windows_change_between_epochs(seq_dfs):
    ds = sequence.SequenceDataset(SEQ_SCHEMA, seq_dfs[0], phase="train", seed=3)
    first = ds.arrays["target_item"].copy()
    ds.resample(0)  # the same epoch again: nothing is redrawn
    np.testing.assert_array_equal(ds.arrays["target_item"], first)
    ds.resample(1)
    assert (ds.arrays["target_item"] != first).any()
    L = SEQ_SCHEMA["max_length"]
    assert ds.arrays["hist_item_list"].shape == (len(ds), L)
    assert set(np.unique(ds.arrays["hist_mask_list"])) <= {0.0, 1.0}


def test_seq_collate_equals_jax():
    rng = np.random.default_rng(0)
    samples = [(rng.integers(0, 9, 5), rng.integers(0, 2, 5), int(rng.integers(1, 9)))
               for _ in range(4)]
    got = sequence.seq_collate(samples)
    want = jax_sequence.seq_collate(samples)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
