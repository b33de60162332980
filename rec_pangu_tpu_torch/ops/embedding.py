"""Embedding tables: ``FusedEmbedding`` (ranking) and ``ItemEmbedding``
(sequence recall).

``FusedEmbedding``: one ``[padded_rows, D]`` table behind all sparse fields.

All F features share one table with static per-feature row offsets, so a
batch lookup is a single ``[B, F]`` (+offsets) -> ``[B, F, D]`` gather, run
by the lookup kernel (``ops/kernels/embedding_lookup.py``) on the card.

The table keeps the JAX package's shape, ``[padded_rows(total_rows), D]``,
so weights carry across unchanged, pad rows included.  In training the
lookup's backward is the table gradient kernel; the fused train step holds
the table out of autograd instead (``forward``'s ``capture``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.encoder import FeatureSpec
from .initializers import kaiming_normal_
from .kernels.embedding_lookup import fused_embedding_lookup

# tables at least this big are padded to an 8192-row multiple (the JAX
# package's planned kernels tile over that size; pad rows are never indexed)
_MIN_TABLE_ROWS = 64 * 1024


def padded_rows(total_rows: int) -> int:
    if total_rows >= _MIN_TABLE_ROWS:
        return -(-total_rows // 8192) * 8192
    return total_rows


def xavier_row_stds(spec: FeatureSpec, dim: int, num_rows: int) -> np.ndarray:
    """Per-row std of the multi-task family's init: feature f's rows get
    ``sqrt(2 / (rows_f + D))`` (torch ``xavier_normal_`` on each per-feature
    table); pad rows get 0."""
    stds = np.zeros((num_rows, 1), np.float32)
    for start, rows in zip(spec.offsets, spec.sparse_vocab_rows):
        stds[int(start):int(start) + int(rows)] = np.sqrt(2.0 / (int(rows) + dim))
    return stds


class FusedEmbedding(nn.Module):
    def __init__(self, spec: FeatureSpec, embedding_dim: int,
                 init_mode: str = "kaiming",
                 generator: Optional[torch.Generator] = None):
        """``init_mode``: "kaiming" (the ranking family, std sqrt(2/D)) or
        "xavier" (the multi-task family, per feature)."""
        super().__init__()
        if init_mode not in ("kaiming", "xavier"):
            raise ValueError(f"init_mode must be 'kaiming' or 'xavier', got {init_mode!r}")
        self.spec = spec
        self.embedding_dim = int(embedding_dim)
        self.table = nn.Parameter(
            torch.empty(padded_rows(spec.total_rows), self.embedding_dim))
        self.register_buffer("offsets", torch.from_numpy(spec.offsets.copy()),
                             persistent=False)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            if init_mode == "xavier":
                stds = xavier_row_stds(spec, self.embedding_dim, self.table.shape[0])
                self.table.normal_(generator=generator).mul_(torch.from_numpy(stds))
            else:
                kaiming_normal_(self.table, generator)

    def forward(self, sparse_ids: torch.Tensor,
                capture: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """[B, F] int32 per-feature ids -> [B, F, D].

        ``capture`` (a list) is the fused train step's capture mode
        (``train/fused_update.py``): the table is held out of autograd, the
        gathered rows become a leaf that requires grad, and they are
        appended to ``capture`` so that the step differentiates the loss by
        them and hands their gradient to the fused table Adam.  The value is
        the same either way."""
        if capture is None:
            return fused_embedding_lookup(self.table, sparse_ids, self.offsets)
        rows = fused_embedding_lookup(self.table.detach(), sparse_ids, self.offsets)
        rows.requires_grad_(True)
        capture.append(rows)
        return rows

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        """(collection, flax path, tensor, transposed) of each weight."""
        return [("params", ("table",), self.table, False)]


class ItemEmbedding(nn.Module):
    """Sequence item vocabulary: a ``[padded_rows(vocab), D]`` table whose
    row 0 (padding and out-of-vocabulary) reads as zero.

    The init is torch's kaiming normal (std sqrt(2/D)) or, with ``init_std``
    (``config['emb_init_std']``), a normal of that std, as in the JAX
    package.  The lookup is the same kernel as ``FusedEmbedding``'s (one
    zero offset over the flattened ids) times ``ids != 0``."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 init_std: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size = int(vocab_size)
        self.embedding_dim = int(embedding_dim)
        self.table = nn.Parameter(torch.empty(padded_rows(self.vocab_size),
                                              self.embedding_dim))
        self.register_buffer("offsets", torch.zeros(1, dtype=torch.int32), persistent=False)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            if init_std is None:
                kaiming_normal_(self.table, generator)
            else:
                self.table.normal_(0.0, float(init_std), generator=generator)

    def all_items(self) -> torch.Tensor:
        """[vocab, D]: the table without its pad rows, row 0 zeroed."""
        keep = torch.arange(self.vocab_size, device=self.table.device) != 0
        return self.table[:self.vocab_size] * keep[:, None]

    def forward(self, ids: torch.Tensor,
                capture: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """[...] int32 item ids -> [..., D]; id 0 gives a zero row.

        ``capture`` (a list) is the sequence fused step's capture mode, as
        ``FusedEmbedding.forward``'s: the table is held out of autograd, the
        gathered rows [N, D] become a leaf appended to ``capture``, and the
        output is still those rows times ``ids != 0``."""
        if capture is None:
            rows = fused_embedding_lookup(self.table, ids.reshape(-1, 1), self.offsets)
        else:
            rows = fused_embedding_lookup(self.table.detach(), ids.reshape(-1, 1), self.offsets)
            rows.requires_grad_(True)
            capture.append(rows)
        return rows.view(*ids.shape, self.embedding_dim) * (ids != 0).unsqueeze(-1)

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        return [("params", ("table",), self.table, False)]


def host_fused_ids(spec: FeatureSpec, sparse) -> np.ndarray:
    """Host (numpy) replica of the fused ids the lookup computes, flattened."""
    return (np.asarray(sparse, dtype=np.int64)
            + np.asarray(spec.offsets, dtype=np.int64)[None, :]).reshape(-1)


def check_ids(spec: FeatureSpec, sparse, num_rows: int) -> None:
    """Raise ValueError when a fused id falls outside a ``num_rows`` table
    (the JAX package's host sort plan makes the same check)."""
    ids = host_fused_ids(spec, sparse)
    if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= num_rows):
        raise ValueError(f"id out of range for a {num_rows}-row table: fused ids "
                         f"span [{int(ids.min())}, {int(ids.max())}]")


def check_item_ids(ids, vocab_size: int) -> None:
    """Raise ValueError when an item id falls outside ``[0, vocab_size)``
    (0 is padding); the rows past the vocabulary are the table's padding."""
    ids = np.asarray(ids)
    if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= vocab_size):
        raise ValueError(f"item id out of range for a vocabulary of {vocab_size}: ids "
                         f"span [{int(ids.min())}, {int(ids.max())}]")
