"""Host-side ranking metrics, bit-compatible with the sklearn calls the
reference makes (rec_pangu/model_pipeline.py:78-86: ``roc_auc_score``,
``log_loss(eps=1e-7)``, rounded to 4 dp).

Implemented in plain numpy (no sklearn dependency on the metric path): AUC via
tie-averaged ranks (exactly the Mann-Whitney statistic sklearn computes for
binary labels), log-loss with the same eps clipping.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks with ties averaged (scipy.stats.rankdata 'average')."""
    order = np.argsort(x, kind="mergesort")
    sx = x[order]
    n = len(x)
    ranks = np.empty(n, dtype=np.float64)
    # boundaries of tied groups in sorted order
    boundary = np.concatenate([[True], sx[1:] != sx[:-1]])
    group_id = np.cumsum(boundary) - 1
    counts = np.bincount(group_id)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    avg = starts + (counts + 1) / 2.0  # average 1-based rank per group
    ranks[order] = avg[group_id]
    return ranks


def roc_auc_score(y_true: Sequence[float], y_score: Sequence[float]) -> float:
    y = np.asarray(y_true, dtype=np.float64).reshape(-1)
    s = np.asarray(y_score, dtype=np.float64).reshape(-1)
    pos = y > 0.5
    n_pos = int(pos.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc_score is undefined with only one class present")
    r = _average_ranks(s)
    return float((r[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def log_loss(y_true: Sequence[float], y_pred: Sequence[float], eps: float = 1e-7) -> float:
    y = np.asarray(y_true, dtype=np.float64).reshape(-1)
    p = np.clip(np.asarray(y_pred, dtype=np.float64).reshape(-1), eps, 1.0 - eps)
    return float(-np.mean(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)))


_METRIC_FNS = {"roc_auc_score": roc_auc_score, "log_loss": log_loss}


class RollingMetricBuffer:
    """Bounded accumulator for train-metric samples.

    The reference grows Python lists for the whole epoch
    (rec_pangu/model_pipeline.py:60-63); this keeps only the most recent
    ``window`` samples, so host memory per epoch is constant regardless of
    epoch length.  Epochs shorter than ``window`` (every bundled fixture)
    produce bit-identical metrics; longer epochs report the train metric
    over the trailing window — the epoch-scale analogue of the reference's
    rolling last-1000 AUC (model_pipeline.py:63).

    Appended arrays may be device arrays; nothing is fetched until
    ``concat()``, so the hot loop stays async.
    """

    def __init__(self, window: int = 1 << 20):
        self.window = int(window)
        self._chunks: List = []
        self._sizes: List[int] = []
        self._total = 0

    def append(self, arr) -> None:
        n = int(arr.shape[0])
        self._chunks.append(arr)
        self._sizes.append(n)
        self._total += n
        # drop whole oldest chunks while the remainder still covers window
        while len(self._sizes) > 1 and self._total - self._sizes[0] >= self.window:
            self._total -= self._sizes[0]
            self._chunks.pop(0)
            self._sizes.pop(0)

    def __len__(self) -> int:
        return min(self._total, self.window)

    def concat(self) -> np.ndarray:
        out = np.concatenate(
            [np.asarray(c).reshape(len(c), -1) for c in self._chunks])
        return out[-self.window:] if len(out) > self.window else out


def compute_ranking_metrics(
    labels: np.ndarray,
    preds: np.ndarray,
    metric_list: Sequence[str] = ("roc_auc_score", "log_loss"),
    prefix: str = "",
    num_task: int = 1,
) -> Dict[str, float]:
    """Metric-name parity with the engine loops:

    * single task, train: ``train_roc_auc_score`` / ``train_log_loss``
      (model_pipeline.py:80-86 with prefix='train_')
    * single task, eval:  ``roc_auc_score`` / ``log_loss`` (prefix='')
    * multi-task: ``{prefix}task{i}_{metric}`` (model_pipeline.py:117-127,205-218)
    """
    res: Dict[str, float] = {}
    for m in metric_list:
        if m not in _METRIC_FNS:
            raise ValueError(f"metric {m!r} not supported; must be in {sorted(_METRIC_FNS)}")
    if num_task == 1:
        for m in metric_list:
            res[f"{prefix}{m}"] = round(_METRIC_FNS[m](labels, preds), 4)
    else:
        labels = np.asarray(labels).reshape(len(labels), num_task)
        preds = np.asarray(preds).reshape(len(preds), num_task)
        for i in range(num_task):
            for m in metric_list:
                res[f"{prefix}task{i + 1}_{m}"] = round(
                    _METRIC_FNS[m](labels[:, i], preds[:, i]), 4
                )
    return res
