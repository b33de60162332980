"""Sequence-recall datasets (session/sequence protocols).

The same protocols as the JAX package's ``data/sequence.py``:

* ``SequenceDataset``: train draws a split point ``k ~ U[4, len)`` per user
  per epoch from ``numpy.random.default_rng(seed)``, in user order (users
  with at most 4 items take ``max(1, len - 1)`` and draw nothing); the
  history is the (up to) ``max_length`` items before ``k``, the target is
  item ``k`` and the next ``next_seq_length`` items follow.  Valid and test
  split at ``int(0.8 * len)``; their ground truth is the last 20% of each
  list.
* ``SequenceDatasetV2``: leave-one-out, train at ``len - 3``, valid at
  ``len - 2``, test at ``len - 1``; the ground truth is the held-out item.

An epoch's windows are fixed-shape ``[U, L]`` arrays built at once with
vectorized numpy (``resample`` rebuilds them; the loader calls it at the
start of every epoch), so a batch is one slice of each array.  The same
seed gives the same arrays as the JAX package.

pandas is imported inside the constructor: the package imports without it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .encoder import OOV_SENTINEL, fit_sequence_enc_dict


class SequenceDataset:
    def __init__(self, config: dict, df, enc_dict: Optional[dict] = None,
                 phase: str = "train", seed: int = 1029):
        import pandas as pd

        self.config = config
        self.max_length = int(config["max_length"])
        self.user_col = config["user_col"]
        self.item_col = config["item_col"]
        self.time_col = config.get("time_col", None)
        self.cate_cols = list(config.get("cate_cols", []) or [])
        self.next_seq_length = int(config.get("next_seq_length", 10))
        self.phase = phase
        self._rng = np.random.default_rng(seed)

        df = df.copy()
        if self.time_col:
            df = df.sort_values(by=[self.user_col, self.time_col], kind="mergesort")
        self.enc_dict = enc_dict if enc_dict is not None else fit_sequence_enc_dict(df, config)
        encoded = {}
        for f in [self.item_col] + self.cate_cols:
            mapping = {k: v for k, v in self.enc_dict[f].items() if k != OOV_SENTINEL}
            encoded[f] = df[f].astype(str).map(mapping).fillna(0).to_numpy(np.int64)

        # users in order of first appearance, each user's rows in frame order
        codes, self.user_list = pd.factorize(df[self.user_col], sort=False)
        order = np.argsort(codes, kind="stable")
        lens = np.bincount(codes, minlength=len(self.user_list)).astype(np.int64)
        self._lens = lens
        self._offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        self._flat = {f: col[order] for f, col in encoded.items()}

        self.arrays: Dict[str, np.ndarray] = {}
        self._built_epoch: Optional[int] = None
        if self.phase == "train":
            self.resample(0)
        else:
            self._build(self._eval_split_points())

    def _item_list(self, u: int) -> np.ndarray:
        return self._flat[self.item_col][self._offsets[u]:self._offsets[u + 1]]

    # -- split-point policies (overridden by V2) --------------------------------
    def _train_split_points(self) -> np.ndarray:
        # one scalar draw per user in order, as the JAX package draws them
        return np.array([self._rng.integers(4, n) if n > 4 else max(1, n - 1)
                         for n in self._lens.tolist()], dtype=np.int64)

    def _eval_split_points(self) -> np.ndarray:
        return np.array([int(0.8 * n) for n in self._lens.tolist()], dtype=np.int64)

    def resample(self, epoch: int) -> None:
        """Rebuild the training windows; a second call for the same epoch
        does nothing."""
        if self.phase != "train" or epoch == self._built_epoch:
            return
        self._built_epoch = epoch
        self._build(self._train_split_points())

    def _take(self, flat: np.ndarray, start: np.ndarray, count: np.ndarray,
              width: int) -> np.ndarray:
        """[U, width] int32: ``flat[offsets[u] + start[u] + p]`` for
        ``p < count[u]``, 0 beyond."""
        pos = np.arange(width)[None, :]
        valid = pos < count[:, None]
        src = self._offsets[:-1, None] + start[:, None] + pos
        if flat.size == 0:
            return np.zeros(valid.shape, np.int32)
        vals = flat[np.clip(src, 0, flat.size - 1)]
        return np.where(valid, vals, 0).astype(np.int32)

    def _build(self, ks: np.ndarray) -> None:
        L, S = self.max_length, self.next_seq_length
        start = np.maximum(ks - L, 0)
        n_hist = ks - start
        items = self._flat[self.item_col]
        arrays: Dict[str, np.ndarray] = {
            "hist_item_list": self._take(items, start, n_hist, L),
            "hist_mask_list": (np.arange(L)[None, :] < n_hist[:, None]).astype(np.float32),
        }
        for c in self.cate_cols:
            arrays[f"hist_{c}_list"] = self._take(self._flat[c], start, n_hist, L)
        if self.phase == "train":
            t = np.maximum(np.minimum(ks, self._lens - 1), 0)
            arrays["target_item"] = self._take(items, t, np.ones_like(ks), 1)[:, 0]
            n_next = np.clip(self._lens - ks, 0, S)
            arrays["next_item_list"] = self._take(items, ks, n_next, S)
            arrays["next_mask_list"] = (np.arange(S)[None, :]
                                        < n_next[:, None]).astype(np.float32)
        else:
            arrays["user"] = np.asarray([str(u) for u in self.user_list], dtype=object)
        self.arrays = arrays

    def __len__(self) -> int:
        return len(self.user_list)

    def get_test_gd(self) -> Dict[str, List[int]]:
        """{user: the held-out items}: the last 20% of each list."""
        return {str(u): [int(x) for x in self._item_list(i)[int(0.8 * n):]]
                for i, (u, n) in enumerate(zip(self.user_list, self._lens.tolist()))}

    @property
    def item_vocab_size(self) -> int:
        return int(self.enc_dict[self.item_col][OOV_SENTINEL])


class SequenceDatasetV2(SequenceDataset):
    """Leave-one-out protocol (train at len-3, valid at len-2, test at len-1)."""

    def _train_split_points(self) -> np.ndarray:
        return np.maximum(self._lens - 3, 1)

    def _delta(self) -> int:
        return 2 if self.phase == "valid" else 1

    def _eval_split_points(self) -> np.ndarray:
        return np.maximum(self._lens - self._delta(), 1)

    def get_test_gd(self) -> Dict[str, List[int]]:
        d = self._delta()
        return {str(u): [int(self._item_list(i)[n - d])]
                for i, (u, n) in enumerate(zip(self.user_list, self._lens.tolist()))}


def seq_collate(batch):
    """Stack (hist_items, hist_mask, target) samples into batch arrays:
    (hist_item [B, L] int64, hist_mask [B, L] int64, the B targets as a list).
    The loaders emit whole batches; this serves loops that collate samples."""
    hist_item = np.stack([np.asarray(s[0]) for s in batch]).astype(np.int64)
    hist_mask = np.stack([np.asarray(s[1]) for s in batch]).astype(np.int64)
    return hist_item, hist_mask, [s[2] for s in batch]
