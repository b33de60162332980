"""Distributed brute-force inner-product top-k, the JAX package's
``parallel/topk.py``.

The item table is split over the ``model`` axis: each ``model`` rank scores
the queries against its own shard with ``torch.matmul`` (a plain product,
as in the JAX package), takes a local ``torch.topk``, and the shards' ``k``
candidates and their global ids are gathered over ``model``; a last
``torch.topk`` over the gathered candidates picks the global top-k, the
same on every rank.  The collective carries ``k`` candidates a shard
instead of a ``[B, V]`` score matrix.  Every rank calls it with the same
queries; ranks that differ only in ``data`` do the same work.  A caller
whose table is already row-sharded (a sequence model's item table under
``shard_state``) passes its own block and the block's first global id
(``first``) instead of the whole table.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .comm import gather_rows
from .mesh import MODEL_AXIS, mesh_shape


def _shard(mesh, item_embs: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """The rank's rows of the whole [V, D] table, their first row, and the
    shard's row count; V must divide the ``model`` axis (``pad_to_multiple``)."""
    n_model = mesh_shape(mesh)[1]
    v = item_embs.shape[0]
    if v % n_model:
        raise ValueError(f"{v} item rows do not split over {n_model} model ranks: "
                         f"pad them (pad_to_multiple)")
    rows = v // n_model
    first = mesh.get_local_rank(MODEL_AXIS) * rows
    return item_embs[first:first + rows], first, rows


def _merge(mesh, scores: torch.Tensor, first: int, k: int):
    """Local top-k of a shard's [B, rows] scores, gathered over ``model``,
    then the global top-k: (scores [B, k], global ids [B, k])."""
    s, i = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    i = i + first
    group = mesh.get_group(MODEL_AXIS)
    s_all = gather_rows(s, group, dim=1)
    i_all = gather_rows(i, group, dim=1)
    s_fin, pos = torch.topk(s_all, k, dim=1)
    return s_fin, torch.gather(i_all, 1, pos)


def _masked_padding(scores: torch.Tensor, first: int, num_valid: int) -> torch.Tensor:
    """Padding rows (global id >= num_valid) scored -inf so they never rank."""
    ids = first + torch.arange(scores.shape[1], device=scores.device)
    return scores.masked_fill(ids[None, :] >= num_valid, float("-inf"))


def distributed_topk(mesh, user_embs: torch.Tensor, item_embs: torch.Tensor, k: int,
                     num_valid: Optional[int] = None, first: Optional[int] = None):
    """user_embs [B, D] x the whole item_embs [V, D] (V divisible by the
    ``model`` axis; each rank scores its own rows) -> (scores [B, k], global
    item ids [B, k]).  ``num_valid`` masks the padding rows appended to make
    V divisible.  With ``first``, ``item_embs`` is the rank's own block of
    rows from global id ``first`` (``num_valid`` then required)."""
    if first is None:
        items, first, _ = _shard(mesh, item_embs)
        num_valid = item_embs.shape[0] if num_valid is None else int(num_valid)
    elif num_valid is None:
        raise ValueError("a block of rows (first=...) needs num_valid, the corpus' size")
    else:
        items, num_valid = item_embs, int(num_valid)
    scores = torch.matmul(user_embs.float(), items.float().t())
    return _merge(mesh, _masked_padding(scores, first, num_valid), first, k)


def distributed_masked_topk(mesh, user_embs: torch.Tensor, item_embs: torch.Tensor,
                            seen: torch.Tensor, k: int, num_valid: Optional[int] = None):
    """``distributed_topk`` with each user's ``seen`` item ids [B, S]
    (global ids, padded with any value >= num_valid) scored -inf before the
    ranking: each shard masks the seen ids inside its rows through a
    sentinel column, as the single-device ``masked_topk`` does
    (GraphTrainer's evaluation under a mesh)."""
    items, first, rows = _shard(mesh, item_embs)
    num_valid = item_embs.shape[0] if num_valid is None else int(num_valid)
    scores = _masked_padding(torch.matmul(user_embs.float(), items.float().t()), first,
                             num_valid)
    local = seen.long() - first
    local = torch.where((local >= 0) & (local < rows), local, rows)  # the sentinel column
    scores = F.pad(scores, (0, 1))
    scores.scatter_(1, local, float("-inf"))
    return _merge(mesh, scores[:, :-1], first, k)


def pad_to_multiple(x: torch.Tensor, multiple: int, dim: int = 0, value: float = 0.0
                    ) -> torch.Tensor:
    """``x`` padded with ``value`` along ``dim`` to a multiple of ``multiple``."""
    rem = (-x.shape[dim]) % multiple
    if rem == 0:
        return x
    pad = [0, 0] * (x.dim() - dim - 1) + [0, rem]
    return F.pad(x, pad, value=value)
