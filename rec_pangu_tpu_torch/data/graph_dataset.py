"""The graph-CF dataset, as the JAX package's ``data/graph_dataset.py``.

BPR sampling over a bipartite user-item graph, and the graph as the dense
degree-normalized interaction matrix ``R_norm [U, I]``:
``R_norm[u, i] = count(u, i) * deg_u^-1/2 * deg_i^-1/2`` (a degree of 0
scales by 0), the bipartite adjacency's one non-zero block, so NGCF's
message passing is two dense products a layer.

The frame is a pandas DataFrame or a mapping of ``user_id`` and
``item_id`` arrays; it is grouped with numpy, so the package imports
without pandas.  ``sample`` makes the JAX package's numpy calls in its
order: one seed gives the same batches, bit for bit.  ``generate_graph``
builds ``R_norm`` on the device it is given, from the edge list (no host
copy of the [U, I] matrix: 4.9 GB at Gowalla's size).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


def group_items(user_ids: np.ndarray, item_ids: np.ndarray) -> Dict[int, List[int]]:
    """{user: that user's items in the frame's order}, users ascending:
    pandas' ``groupby("user_id")["item_id"].apply(list).to_dict()``."""
    order = np.argsort(user_ids, kind="stable")
    users, starts = np.unique(user_ids[order], return_index=True)
    groups = np.split(item_ids[order], starts[1:])
    return {int(u): g.tolist() for u, g in zip(users, groups)}


class GeneralGraphDataset:
    def __init__(self, df, num_user: int, num_item: int, phase: str = "train",
                 seed: int = 1029):
        self.df = df
        self.num_user = int(num_user)
        self.num_item = int(num_item)
        self.phase = phase
        self._rng = np.random.default_rng(seed)
        self.user_ids = np.asarray(df["user_id"]).astype(np.int32)
        self.item_ids = np.asarray(df["item_id"]).astype(np.int32)
        self.test_gd = group_items(self.user_ids, self.item_ids)
        self.user_list = list(self.test_gd.keys())

    def generate_graph(self, device: DeviceLike = None) -> torch.Tensor:
        """R_norm [U, I] float32 on ``device`` (the CUDA card by default):
        the edge counts accumulated into zeros, then the two degree
        scalings, in place."""
        dev = resolve_device(device)
        r = torch.zeros(self.num_user, self.num_item, dtype=torch.float32, device=dev)
        u = torch.from_numpy(self.user_ids.astype(np.int64)).to(dev)
        i = torch.from_numpy(self.item_ids.astype(np.int64)).to(dev)
        r.index_put_((u, i), torch.ones(len(self.user_ids), device=dev), accumulate=True)
        deg_u, deg_i = r.sum(dim=1), r.sum(dim=0)   # integer counts: exact in any order
        nu = torch.where(deg_u > 0, deg_u.pow(-0.5), torch.zeros_like(deg_u))
        ni = torch.where(deg_i > 0, deg_i.pow(-0.5), torch.zeros_like(deg_i))
        return r.mul_(nu[:, None]).mul_(ni[None, :])

    def sample(self, batch_size: int = 1024) -> Dict[str, np.ndarray]:
        """One BPR batch: a user, one of their items, one negative item
        (resampled until the user has not seen it)."""
        users = self._rng.choice(len(self.user_list), size=batch_size,
                                 replace=batch_size > len(self.user_list))
        users = np.asarray([self.user_list[i] for i in users], dtype=np.int64)
        pos = np.asarray([
            self.test_gd[u][self._rng.integers(0, len(self.test_gd[u]))]
            for u in users], dtype=np.int64)
        neg = self._rng.integers(0, self.num_item, size=batch_size)
        for i, u in enumerate(users):  # rejection resample collisions
            seen = set(self.test_gd[u])
            while int(neg[i]) in seen:
                neg[i] = self._rng.integers(0, self.num_item)
        return {"user_id": users.astype(np.int32), "pos_item_id": pos.astype(np.int32),
                "neg_item_id": neg.astype(np.int32)}

    def __len__(self) -> int:
        if self.phase == "train":
            return len(self.user_ids)
        return len(self.user_list)

