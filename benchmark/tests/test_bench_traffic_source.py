"""The sequence traffic mixes' lengths and popularity are derived from the
repo's MovieLens-1M sample, as each file's ``derived`` says: this test
derives them again."""
import csv
import json
from collections import Counter

import numpy as np
import pytest

from benchmark.tests.tiny import ROOT

SAMPLE = ROOT / "examples" / "sequence_recall" / "sample_data"
MAX_LENGTH = 50


def ratings_per_user_and_item():
    users, items = Counter(), Counter()
    for split in ("train", "valid", "test"):
        with open(SAMPLE / f"sample_{split}.csv", newline="") as f:
            for row in csv.DictReader(f):
                users[row["user_id"]] += 1
                items[row["item_id"]] += 1
    return np.array(list(users.values())), np.array(sorted(items.values(), reverse=True))


def zipf_mle(counts: np.ndarray) -> float:
    """The exponent a that maximises the likelihood of the ratings' ranks
    under p(rank) proportional to rank ** -a (golden-section search)."""
    ranks = np.arange(1, len(counts) + 1, dtype=np.float64)
    mean_log_rank = float((counts * np.log(ranks)).sum() / counts.sum())

    def nll(a):
        return a * mean_log_rank + np.log(np.sum(ranks ** -a))

    lo, hi, g = 0.01, 3.0, (np.sqrt(5) - 1) / 2
    while hi - lo > 1e-7:
        c, d = hi - g * (hi - lo), lo + g * (hi - lo)
        lo, hi = (lo, d) if nll(c) < nll(d) else (c, hi)
    return (lo + hi) / 2


def traffic(name):
    return json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def sample():
    return ratings_per_user_and_item()


@pytest.mark.parametrize("name", ["seq_train_b2048", "retrieve_b1024_top200"])
def test_zipf_exponent_is_the_samples(sample, name):
    _, items = sample
    assert traffic(name)["zipf"] == pytest.approx(zipf_mle(items), abs=5e-4)


def test_training_lengths_are_recboles_augmentation(sample):
    users, _ = sample
    want = np.zeros(MAX_LENGTH, np.int64)
    for n in users:  # histories of the first i items, i = 1 .. n - 3
        for i in range(1, n - 2):
            want[min(i, MAX_LENGTH) - 1] += 1
    assert traffic("seq_train_b2048")["length_weights"] == want.tolist()


def test_retrieval_lengths_are_the_served_histories(sample):
    users, _ = sample
    want = np.bincount(np.minimum(users - 1, MAX_LENGTH) - 1, minlength=MAX_LENGTH)
    assert traffic("retrieve_b1024_top200")["length_weights"] == want.tolist()
