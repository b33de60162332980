"""Full-softmax cross-entropy over a large item corpus, streamed in chunks.

The sequence-recall loss is ``mean_b [logsumexp_v(u_b . item_v) - u_b .
item_{pos_b}]`` over the whole corpus.  At 1024 users and 1,000,000 items the
``[B, V]`` logits are 4 GB; the functions here never hold them whole.  The
forward walks the corpus in chunks of ``CHUNK_V`` items, takes each chunk's
logsumexp, combines them as a running logsumexp and picks each positive's
logit out of the chunk that holds it.  The backward recomputes each chunk's
softmax in place from the saved logsumexp (the chunk's elementwise passes,
not its products, are most of its time), subtracts the positives' one-hot
inside the chunk (the JAX scan's ``p - onehot``) and takes ``d_user += p @
chunk`` and ``d_chunk = p^T @ user`` as two matrix products.  No scatter:
the gradient is the same bits on every run.

This is the JAX package's ``ops/softmax_ce.py`` (``fused_softmax_ce``,
``_padded_ce`` behind ``fused_softmax_ce_padded`` and
``fused_softmax_ce_captured``, ``full_softmax_ce``); there it is an XLA scan,
not a Pallas kernel, and here the chunk products are ``torch.matmul``.
``CHUNK_V`` there is 8192, a TPU VMEM size; on the card a chunk is 131,072
items (a 512 MB logits block at 1024 users, about ten launches), so the
bench corpus takes 8 chunks each way.  The table need not be a multiple of
the chunk.

Semantics of the padded variants, as in JAX: rows at or past ``valid_v``
(the table's padding) score -inf; with ``zero_row0`` row 0 (padding and
out-of-vocabulary) scores exactly 0, counts in the denominator and gets no
gradient, and neither does a target of 0.  The captured variant does not
give the table a gradient: its backward appends the dense item gradient, in
the table's own ``[V_pad, D]`` layout, to the caller's list, for the fused
train step's Adam pass.

The K-max CE of multi-interest models (IOCRec), ``mean_b [logsumexp_v(max_k
u_bk . item_v) - max_k u_bk . item_{pos_b}]``, is the JAX package's
``fused_multimax_softmax_ce`` and ``fused_multimax_softmax_ce_captured``:
its logsumexp and the softmax term of its gradient are the K5 kernels
(``ops/kernels/multimax_ce.py``), and the positive-class terms, routed to the
interest that wins the positive (the lowest on a tie), are applied here, as
JAX applies them.  The positives' item gradient is added with
``index_put_(accumulate=True)``, which sums repeated positives in a fixed
order.  ``fused_multimax_softmax_ce_padded`` runs over the raw table with
the padded variant's semantics, with no copy of it.

``sharded_softmax_ce`` and ``sharded_multimax_softmax_ce`` are the same two
autograd Functions over a table row-sharded over the mesh's ``model`` axis,
given the block's first row and the axis's group: the per-rank logsumexps
are log-added over the group and the user gradient is summed over it.
Without a group they compute the whole table's CE.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch

from ..utils.trace import span
from .kernels.multimax_ce import multimax_grads, multimax_lse

CHUNK_V = 131_072         # items a chunk on the card
_FUSED_MIN_VOCAB = 65_536  # below it, full_softmax_ce keeps the naive path, as in JAX


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One of the CE's chunk products, spanned as ``ce.product``."""
    with span("ce.product"):
        return torch.matmul(a, b)


def _chunk_logits(user, chunk, base: int, valid_v: int, zero_row0: bool) -> torch.Tensor:
    """[B, C] logits of one chunk, rows past ``valid_v`` -inf, row 0 pinned
    to 0 when ``zero_row0``."""
    logits = _product(user, chunk.t())
    stop = base + chunk.shape[0]
    if stop > valid_v:
        logits[:, max(valid_v - base, 0):] = -torch.inf
    if zero_row0 and base == 0:
        logits[:, 0] = 0.0
    return logits


def _chunks(num_rows: int, chunk: int):
    return range(0, num_rows, chunk)


def _lse_pos(user, items, pos, valid_v: int, zero_row0: bool, chunk: int, first: int = 0):
    """(logsumexp [B], positive logit [B]) in one pass over the corpus: each
    chunk's logsumexp, combined across chunks as a running logsumexp.
    ``items`` are the rows from global id ``first`` on (a row-sharded
    table's block; the positive logit is 0 where the block lacks it)."""
    B = user.shape[0]
    lse = torch.full((B,), -torch.inf, dtype=torch.float32, device=user.device)
    ps = torch.zeros(B, dtype=torch.float32, device=user.device)
    for local in _chunks(items.shape[0], chunk):
        c = items[local:local + chunk]
        base = first + local
        logits = _chunk_logits(user, c, base, valid_v, zero_row0)
        loc = pos - base
        hit = (loc >= 0) & (loc < c.shape[0])
        val = logits.gather(1, loc.clamp(0, c.shape[0] - 1)[:, None])[:, 0]
        ps = ps + torch.where(hit, val, 0.0)
        lse = torch.logaddexp(lse, torch.logsumexp(logits, dim=-1))
    return lse, ps


def _grads(user, items, pos, lse, g, valid_v: int, zero_row0: bool, chunk: int,
           first: int = 0):
    """(d_user [B, D] unscaled, d_items [rows, D] scaled by g / B);
    ``first`` as ``_lse_pos``'s."""
    scale = g / user.shape[0]
    d_user = torch.zeros_like(user)
    d_items = torch.empty_like(items)
    for local in _chunks(items.shape[0], chunk):
        c = items[local:local + chunk]
        base = first + local
        p = _chunk_logits(user, c, base, valid_v, zero_row0)
        p.sub_(lse[:, None]).exp_()  # in place: the chunk's passes are its bytes
        loc = pos - base
        hit = (loc >= 0) & (loc < c.shape[0])
        # p - onehot(pos): one term a row, so no two adds meet an element
        # (rows whose positive lies elsewhere add -0)
        p.scatter_add_(1, loc.clamp(0, c.shape[0] - 1)[:, None], -hit.to(p.dtype)[:, None])
        if zero_row0 and base == 0:
            p[:, 0] = 0.0  # row 0 reads as a zero vector: no gradient either way
        d_user += _product(p, c)
        d_items[local:local + c.shape[0]] = _product(p.t(), user) * scale
    return d_user, d_items


def _log_add(lse_r: torch.Tensor, group) -> torch.Tensor:
    """The logsumexp over ``group`` of each rank's partial logsumexp: the
    max, then the log of the summed exponentials (a rank whose rows are all
    masked adds exp(-inf) = 0)."""
    from ..parallel.comm import all_reduce_max, all_reduce_sum

    m = all_reduce_max(lse_r, group)
    safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return safe + torch.log(all_reduce_sum(torch.exp(lse_r - safe), group))


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    from ..parallel.comm import all_reduce_sum

    return all_reduce_sum(x, group)


class _StreamingCE(torch.autograd.Function):
    """The streamed CE over ``items``, the table's rows from global id
    ``first`` on.  With a ``group`` (the mesh's ``model`` axis, over which
    the table is row-sharded: every rank holds the same users and its own
    block) each rank's logsumexp is log-added over the group and the
    positive logit comes from the rank whose block holds it (the others add
    0).  The backward recomputes the block's softmax from the global
    logsumexp, which gives the block's own gradient and its share of the
    user gradient; the shares are summed over the group, so every rank
    hands the same, whole user gradient to the layers below (each rank runs
    them on the same users: neither a summing nor a dividing rule in their
    backward).  Without a group it is the whole table's CE."""

    @staticmethod
    def forward(ctx, user, items, pos, first, valid_v, zero_row0, chunk, sink, group):
        with span("ce.forward"):
            pos = pos.reshape(-1).long()
            lse, ps = _lse_pos(user, items, pos, valid_v, zero_row0, chunk, first)
            if group is not None:
                lse, ps = _log_add(lse, group), _sum_over(ps, group)
            ctx.save_for_backward(user, items, pos, lse)
            ctx.options = (first, valid_v, zero_row0, chunk, sink, group)
            return (lse - ps).mean()

    @staticmethod
    def backward(ctx, g):
        user, items, pos, lse = ctx.saved_tensors
        first, valid_v, zero_row0, chunk, sink, group = ctx.options
        with span("ce.backward"):
            d_user, d_items = _grads(user, items, pos, lse, g, valid_v, zero_row0, chunk, first)
            d_user = _sum_over(d_user, group) * (g / user.shape[0])
        if sink is not None:
            sink.append(d_items)
            d_items = None
        elif not ctx.needs_input_grad[1]:
            d_items = None
        return d_user, d_items, None, None, None, None, None, None, None


def _streaming(user, items, pos, valid_v, zero_row0, chunk, sink=None, first=0, group=None):
    if user.dim() != 2 or items.dim() != 2 or user.shape[1] != items.shape[1]:
        raise ValueError(f"user_emb [B, D] and items [V, D] expected, got "
                         f"{tuple(user.shape)} and {tuple(items.shape)}")
    chunk = CHUNK_V if chunk is None else int(chunk)
    return _StreamingCE.apply(user, items, pos, int(first), int(valid_v), bool(zero_row0),
                              chunk, sink, group)


def sharded_softmax_ce(user_emb: torch.Tensor, block: torch.Tensor, pos_item: torch.Tensor,
                       first: int, valid_v: int, group, zero_row0: bool = True,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """``fused_softmax_ce_padded`` over a table row-sharded over ``group``
    (the ``model`` axis): ``block`` the rank's rows, from global id
    ``first``.  No rank holds or gathers the whole table; the loss and the
    user gradient are the same on every rank of the group."""
    return _streaming(user_emb, block, pos_item, valid_v, zero_row0, chunk, first=first,
                      group=group)


def fused_softmax_ce(user_emb: torch.Tensor, items: torch.Tensor, pos_item: torch.Tensor,
                     chunk: Optional[int] = None) -> torch.Tensor:
    """mean_b [logsumexp_v(user_b . item_v) - user_b . item_{pos_b}], streamed."""
    return _streaming(user_emb, items, pos_item, items.shape[0], False, chunk)


def fused_softmax_ce_padded(user_emb: torch.Tensor, items_padded: torch.Tensor,
                            pos_item: torch.Tensor, valid_v: int, zero_row0: bool = True,
                            chunk: Optional[int] = None) -> torch.Tensor:
    """The streamed CE over the raw table [V_pad, D], with no copy of it:
    rows past ``valid_v`` masked, row 0 read as zero (``zero_row0``)."""
    return _streaming(user_emb, items_padded, pos_item, valid_v, zero_row0, chunk)


def fused_softmax_ce_captured(user_emb: torch.Tensor, items_padded: torch.Tensor,
                              pos_item: torch.Tensor, sink: List[torch.Tensor], valid_v: int,
                              zero_row0: bool = True,
                              chunk: Optional[int] = None) -> torch.Tensor:
    """``fused_softmax_ce_padded`` whose backward appends the table's dense
    gradient [V_pad, D] to ``sink`` instead of giving it to the table (pass
    the table detached)."""
    return _streaming(user_emb, items_padded, pos_item, valid_v, zero_row0, chunk, sink)


def fused_ce_enabled() -> bool:
    """``REC_PANGU_TPU_FUSED_CE`` is not 0/off/false."""
    return os.environ.get("REC_PANGU_TPU_FUSED_CE", "auto") not in ("0", "off", "false")


def streamed_ce_applies(num_items: int) -> bool:
    """The streamed form for corpora of at least 65,536 items;
    ``REC_PANGU_TPU_FUSED_CE`` =0 forces the naive path, =1 the streamed one."""
    flag = os.environ.get("REC_PANGU_TPU_FUSED_CE", "auto")
    return flag == "1" or (fused_ce_enabled() and num_items >= _FUSED_MIN_VOCAB)


def full_softmax_ce(user_emb: torch.Tensor, items: torch.Tensor,
                    pos_item: torch.Tensor) -> torch.Tensor:
    """Full-softmax CE; the streamed form where ``streamed_ce_applies``, the
    naive ``[B, V]`` log-softmax elsewhere."""
    if streamed_ce_applies(items.shape[0]):
        return fused_softmax_ce(user_emb, items, pos_item)
    logprobs = torch.log_softmax(torch.matmul(user_emb, items.t()), dim=-1)
    pos = pos_item.reshape(-1).long()
    return -logprobs.gather(1, pos[:, None])[:, 0].mean()


def _pos_rows(items: torch.Tensor, pos: torch.Tensor, first: int, zero_row0: bool,
              group) -> torch.Tensor:
    """The positives' rows [B, D] of ``items``, the table's rows from global
    id ``first`` on: each rank's rows of the positives it holds (zero
    elsewhere), summed over ``group``."""
    local = pos - first
    owned = (local >= 0) & (local < items.shape[0])
    rows = _sum_over(items[local.clamp(0, items.shape[0] - 1)]
                     * owned.to(items.dtype)[:, None], group)
    if zero_row0:
        rows = rows * (pos != 0).to(rows.dtype)[:, None]
    return rows


class _MultimaxCE(torch.autograd.Function):
    """The K-max CE over ``items``, the table's rows from global id
    ``first`` on; with a ``group`` (the ``model`` axis) as
    ``_StreamingCE``'s: K5f on the rank's block gives a partial logsumexp
    (the block's own valid rows; a block of padding only adds nothing), the
    partials are log-added over the group, and K5b on the global logsumexp
    gives the block's item gradient and its share of du, summed over the
    group before the positive term is applied once.  The positives' rows
    come from the ranks that own them; the interest that wins a positive is
    the first on a tie."""

    @staticmethod
    def forward(ctx, user_embs, items, pos, first, valid_v, zero_row0, sink, group):
        pos = pos.reshape(-1).long()
        local_v = min(max(valid_v - first, 0), items.shape[0])
        local_zero = zero_row0 and first == 0
        if local_v > 0:
            lse = multimax_lse(user_embs, items, local_v, local_zero)
        else:
            lse = torch.full((user_embs.shape[0],), -torch.inf, dtype=torch.float32,
                             device=user_embs.device)
        if group is not None:
            lse = _log_add(lse, group)
        rows = _pos_rows(items, pos, first, zero_row0, group)
        scores = torch.einsum("bkd,bd->bk", user_embs, rows)
        k_pos = torch.argmax(scores, dim=-1)
        z_pos = scores.gather(1, k_pos[:, None])[:, 0]
        ctx.save_for_backward(user_embs, items, pos, lse, rows, k_pos)
        ctx.options = (first, local_v, local_zero, sink, group)
        return (lse - z_pos).mean()

    @staticmethod
    def backward(ctx, g):
        user_embs, items, pos, lse, rows, k_pos = ctx.saved_tensors
        first, local_v, local_zero, sink, group = ctx.options
        B, K, _ = user_embs.shape
        scale = g / B
        if local_v > 0:
            du, d_items = multimax_grads(user_embs, items, lse, local_v, local_zero)
        else:
            du, d_items = torch.zeros_like(user_embs), torch.zeros_like(items)
        du = _sum_over(du, group)
        onehot = torch.nn.functional.one_hot(k_pos, K).to(du.dtype)  # [B, K]
        du = (du - onehot[..., None] * rows[:, None, :]) * scale
        u_star = torch.einsum("bk,bkd->bd", onehot, user_embs)
        d_items.mul_(scale)
        # the positives' term on the rows this block holds (the others add 0)
        local = pos - first
        owned = (local >= 0) & (local < items.shape[0])
        d_items.index_put_((local.clamp(0, items.shape[0] - 1),),
                           -u_star * scale * owned.to(u_star.dtype)[:, None], accumulate=True)
        if local_zero:
            d_items[0] = 0.0  # row 0 read as a zero vector: no gradient either way
        if sink is not None:
            sink.append(d_items)
            d_items = None
        elif not ctx.needs_input_grad[1]:
            d_items = None
        return du, d_items, None, None, None, None, None, None


def _multimax(user_embs, items, pos, valid_v, zero_row0, sink=None, first=0, group=None):
    if user_embs.dim() != 3 or items.dim() != 2 or user_embs.shape[2] != items.shape[1]:
        raise ValueError(f"user_embs [B, K, D] and items [V, D] expected, got "
                         f"{tuple(user_embs.shape)} and {tuple(items.shape)}")
    return _MultimaxCE.apply(user_embs, items, pos, int(first), int(valid_v), bool(zero_row0),
                             sink, group)


def sharded_multimax_softmax_ce(user_embs: torch.Tensor, block: torch.Tensor,
                                pos_item: torch.Tensor, first: int, valid_v: int, group,
                                zero_row0: bool = True) -> torch.Tensor:
    """``fused_multimax_softmax_ce_padded`` over a table row-sharded over
    ``group`` (the ``model`` axis): ``block`` the rank's rows, from global id
    ``first``; no rank holds or gathers the whole table."""
    return _multimax(user_embs, block, pos_item, valid_v, zero_row0, first=first, group=group)


def fused_multimax_softmax_ce(user_embs: torch.Tensor, items: torch.Tensor,
                              pos_item: torch.Tensor) -> torch.Tensor:
    """mean_b [logsumexp_v(max_k u_bk . item_v) - max_k u_bk . item_{pos_b}]
    over every row of ``items`` [V, D], never holding the [B, K, V] logits."""
    return _multimax(user_embs, items, pos_item, items.shape[0], False)


def fused_multimax_softmax_ce_padded(user_embs: torch.Tensor, items_padded: torch.Tensor,
                                     pos_item: torch.Tensor, valid_v: int,
                                     zero_row0: bool = True) -> torch.Tensor:
    """The K-max CE over the raw table [V_pad, D], with no copy of it: rows
    past ``valid_v`` masked, row 0 read as zero (``zero_row0``)."""
    return _multimax(user_embs, items_padded, pos_item, valid_v, zero_row0)


def fused_multimax_softmax_ce_captured(user_embs: torch.Tensor, items_padded: torch.Tensor,
                                       pos_item: torch.Tensor, sink: List[torch.Tensor],
                                       valid_v: int, zero_row0: bool = True) -> torch.Tensor:
    """``fused_multimax_softmax_ce_padded`` whose backward appends the
    table's dense gradient [V_pad, D] (row 0 pinned to 0) to ``sink``
    instead of giving it to the table (pass the table detached)."""
    return _multimax(user_embs, items_padded, pos_item, valid_v, zero_row0, sink)


def naive_multimax_softmax_ce(user_embs: torch.Tensor, items: torch.Tensor,
                              pos_item: torch.Tensor) -> torch.Tensor:
    """The K-max CE over the materialized [B, K, V] logits (below
    ``_FUSED_MIN_VOCAB`` items, as in JAX)."""
    logits = torch.einsum("bkd,nd->bkn", user_embs, items).amax(dim=1)
    pos = pos_item.reshape(-1).long()
    return -torch.log_softmax(logits, dim=-1).gather(1, pos[:, None])[:, 0].mean()
