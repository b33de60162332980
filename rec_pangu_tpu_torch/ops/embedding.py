"""Embedding tables: ``FusedEmbedding`` (ranking), ``LRLayer`` (the ranking
models' wide part, a ``[V, 1]`` table) and ``ItemEmbedding`` (sequence
recall).

``FusedEmbedding``: one ``[padded_rows, D]`` table behind all sparse fields.
Under a mesh whose ``model`` axis row-shards it, each rank keeps a block
of its rows and the lookup sums the blocks' rows over that axis
(``sharded_lookup``); ``ItemEmbedding`` does the same with its item
table.

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
from .initializers import kaiming_normal_, torch_linear_bias_
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
        # (first row, whole rows) of the rank's block once shard_state
        # row-shards the table over a mesh's model axis, and the MeshState
        self.row_shard: Optional[Tuple[int, int]] = None
        self.mesh_state = None
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
        gathered rows become a leaf that requires grad, and ``(self, rows)``
        is appended to ``capture`` so that the step differentiates the loss
        by them and hands their gradient to this table's fused Adam.  The
        value is the same either way."""
        if self.row_shard is not None:
            return sharded_lookup(self, sparse_ids, capture)
        if capture is None:
            return fused_embedding_lookup(self.table, sparse_ids, self.offsets)
        rows = fused_embedding_lookup(self.table.detach(), sparse_ids, self.offsets)
        rows.requires_grad_(True)
        capture.append((self, rows))
        return rows

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        """(collection, flax path, tensor, transposed) of each weight."""
        return [("params", ("table",), self.table, False)]


def sharded_lookup(emb: nn.Module, ids: torch.Tensor, capture) -> torch.Tensor:
    """The lookup of an embedding whose table is row-sharded over the mesh's
    ``model`` axis (``parallel/sharding.shard_state``): the kernel on the
    rank's rows with the ids shifted by the block's first row (ids of other
    blocks fall outside it and read zero rows), then the sum over ``model``
    with an identity backward, so that the shard's gradient is the table
    gradient kernel on the shifted ids from the rank's own cotangent.  The
    fused steps do not run on a sharded table."""
    from ..parallel.comm import reduce_model  # here: the parallel package imports ops

    if capture is not None:
        raise ValueError("the fused step does not run on a row-sharded table: a mesh "
                         "with a model axis takes the standard step")
    rows = fused_embedding_lookup(emb.table, ids, emb.shard_offsets)
    return reduce_model(rows, emb.mesh_state.model_group)


class LRLayer(nn.Module):
    """The wide (linear) part of the ranking models: a ``[padded_rows, 1]``
    ``FusedEmbedding`` of the sparse fields, its F values beside the dense
    features, one ``Linear`` to a logit [B, 1].  flax names
    ``FusedEmbedding_0/table`` and ``Dense_0`` (fan-in normal kernel,
    torch's uniform bias).  Its lookup is the same kernel at D = 1; in
    training its table is one of the fused step's tables."""

    def __init__(self, spec: FeatureSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.embedding = FusedEmbedding(spec, 1, generator=generator)
        fan_in = spec.num_sparse + spec.num_dense
        self.dense = nn.Linear(fan_in, 1)
        kaiming_normal_(self.dense.weight, generator)
        torch_linear_bias_(self.dense.bias, fan_in, generator)

    def forward(self, sparse_ids: torch.Tensor, dense: torch.Tensor,
                capture: Optional[List] = None) -> torch.Tensor:
        emb = self.embedding(sparse_ids, capture)[..., 0]          # [B, F]
        return self.dense(torch.cat([emb, dense], dim=1))

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        return [("params", ("FusedEmbedding_0", "table"), self.embedding.table, False),
                ("params", ("Dense_0", "kernel"), self.dense.weight, True),
                ("params", ("Dense_0", "bias"), self.dense.bias, False)]


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
        # (first row, whole rows) of the rank's block once shard_state
        # row-shards the table over a mesh's model axis, and the MeshState
        self.row_shard: Optional[Tuple[int, int]] = None
        self.mesh_state = None
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            if init_std is None:
                kaiming_normal_(self.table, generator)
            else:
                self.table.normal_(0.0, float(init_std), generator=generator)

    def all_items(self) -> torch.Tensor:
        """[vocab, D]: the table without its pad rows, row 0 zeroed.  A
        row-sharded table has no whole corpus on a rank: it raises
        (``local_items`` is the rank's block)."""
        if self.row_shard is not None:
            raise ValueError("the item table is row-sharded over the mesh's model axis: read "
                             "the rank's rows with local_items")
        keep = torch.arange(self.vocab_size, device=self.table.device) != 0
        return self.table[:self.vocab_size] * keep[:, None]

    def local_items(self) -> Tuple[torch.Tensor, int]:
        """(the rank's rows of the corpus [rows, D] with row 0 zeroed, the
        global id of its first row): the whole table's on an unsharded
        table.  Rows at or past ``vocab_size`` (the table's padding) are
        kept for the caller to mask."""
        first = 0 if self.row_shard is None else self.row_shard[0]
        keep = torch.arange(first, first + self.table.shape[0], device=self.table.device) != 0
        return self.table * keep[:, None], first

    def forward(self, ids: torch.Tensor,
                capture: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """[...] int32 item ids -> [..., D]; id 0 gives a zero row.

        ``capture`` (a list) is the sequence fused step's capture mode, as
        ``FusedEmbedding.forward``'s: the table is held out of autograd, the
        gathered rows [N, D] become a leaf appended to ``capture``, and the
        output is still those rows times ``ids != 0``.  A row-sharded table
        takes ``sharded_lookup``."""
        if self.row_shard is not None:
            rows = sharded_lookup(self, ids.reshape(-1, 1), capture)
        elif capture is None:
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
