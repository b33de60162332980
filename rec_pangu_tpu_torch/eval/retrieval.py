"""Full-corpus retrieval evaluation, as the JAX package's ``eval/retrieval.py``.

* ``get_recall_predict``: L2-normalized user and item embeddings, exact
  inner-product top-N over the whole corpus (``torch.matmul`` then
  ``torch.topk`` on the model's device).  A multi-interest model's
  ``[B, K, D]`` embeddings give B*K queries whose lists are merged per user
  by score, deduplicated, with item 0 dropped; a single-interest model's
  top-N is kept as it is, id 0 included (the reference's quirk).
* ``evaluate_recall``: recall, ndcg and hit rate at N, with the reference's
  ndcg quirk: idcg is taken from the final hit count.

``approx_recall_target`` selects the TPU's approximate top-k in the JAX
package; here every top-k is exact, which meets any recall target.
``get_recall_predict(mesh=...)`` scores through the distributed top-k
(``parallel/topk.distributed_topk``): every rank runs every batch, each
``model`` rank scores its rows of the normalized item table (padded to a
multiple of the axis; on a model whose item table is row-sharded, the
rank's own rows, ``output_item_block``), and every rank gets the same
lists.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import mesh_shape
from ..parallel.topk import distributed_topk, pad_to_multiple


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalize; zero rows stay zero."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def make_topn_scorer(item_embs: torch.Tensor, topn: int,
                     approx_recall_target: Optional[float] = None
                     ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """user_embs [B, D] -> (scores [B, topn], ids [B, topn]) against the
    normalized ``item_embs``, on their device.  ``approx_recall_target`` is
    accepted and answered exactly."""
    items = l2_normalize(item_embs.float())

    def score(user_embs: torch.Tensor):
        scores = torch.matmul(l2_normalize(user_embs.float()), items.T)
        return torch.topk(scores, topn, dim=-1)

    return score


def merge_multi_interest(ids: np.ndarray, scores: np.ndarray, topn: int) -> List[int]:
    """Merge one user's K interest lists: by score, descending, deduplicated,
    item 0 dropped, the first ``topn`` (the reference's per-user loop)."""
    flat = sorted(zip(ids.reshape(-1).tolist(), scores.reshape(-1).tolist()),
                  key=lambda t: t[1], reverse=True)
    seen: List[int] = []
    seen_set = set()
    for iid, _ in flat:
        if iid != 0 and iid not in seen_set:
            seen.append(iid)
            seen_set.add(iid)
            if len(seen) >= topn:
                break
    return seen


def batched_merge_multi_interest_np(ids: np.ndarray, scores: np.ndarray, topn: int):
    """``merge_multi_interest`` for a batch of [B, K*N] lists at once:
    (merged [B, topn] ids padded with 0, counts [B])."""
    b, n = ids.shape
    key = np.where(ids == 0, -np.inf, scores.astype(np.float64))
    order = np.argsort(-key, axis=1, kind="stable")
    ids_s = np.take_along_axis(ids, order, axis=1)
    ord2 = np.argsort(ids_s, axis=1, kind="stable")
    ids_g = np.take_along_axis(ids_s, ord2, axis=1)
    first_g = np.concatenate(
        [np.ones((b, 1), bool), ids_g[:, 1:] != ids_g[:, :-1]], axis=1)
    rows = np.arange(b)[:, None]
    keep = np.zeros((b, n), bool)
    keep[rows, ord2] = first_g
    keep &= ids_s != 0
    pos = np.cumsum(keep, axis=1) - 1
    valid = keep & (pos < topn)
    merged = np.zeros((b, topn), ids.dtype)
    merged[np.nonzero(valid)[0], pos[valid]] = ids_s[valid]
    counts = np.minimum(keep.sum(axis=1), topn)
    return merged, counts


def make_mesh_topn_scorer(mesh, item_embs: torch.Tensor, topn: int,
                          first: Optional[int] = None, num_valid: Optional[int] = None
                          ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """``make_topn_scorer`` over a mesh: the normalized items padded to a
    multiple of the ``model`` axis, each rank scoring its own rows
    (``distributed_topk``, the pads masked out).  With ``first``,
    ``item_embs`` is the rank's own block of a row-sharded corpus from
    global id ``first``, of which ids below ``num_valid`` are items."""
    items = l2_normalize(item_embs.float())
    if first is None:
        num_valid = items.shape[0]
        items = pad_to_multiple(items, mesh_shape(mesh)[1])

    def score(user_embs: torch.Tensor):
        return distributed_topk(mesh, l2_normalize(user_embs.float()), items, topn,
                                num_valid=num_valid, first=first)

    return score


def get_recall_predict(model, test_loader, topn: int = 200, user_emb_key: str = "user_emb",
                       mesh=None, approx_recall_target: Optional[float] = None
                       ) -> Dict[str, List[int]]:
    """{user: top-N item ids} for every batch of ``test_loader``, on the
    device where ``model`` lies; with ``mesh``, the distributed top-k over
    the item table split across ``model`` (call it on every rank)."""
    dev = next(model.parameters()).device
    preds: Dict[str, List[int]] = {}
    with torch.inference_mode():
        if mesh is None:
            scorer = make_topn_scorer(model.output_items(), topn, approx_recall_target)
        elif getattr(getattr(model, "item_emb", None), "row_shard", None) is not None:
            block, first = model.output_item_block()
            scorer = make_mesh_topn_scorer(mesh, block, topn, first=first,
                                           num_valid=model.item_emb.vocab_size)
        else:
            scorer = make_mesh_topn_scorer(mesh, model.output_items(), topn)
        for batch in test_loader:
            user_embs = model(model.upload_batch(batch, dev), train=False)[user_emb_key]
            users = batch["user"]
            if user_embs.dim() == 2:
                ids = scorer(user_embs)[1].cpu().numpy()
                for i, u in enumerate(users):
                    preds[str(u)] = ids[i].tolist()
            else:
                B, K, D = user_embs.shape
                scores, ids = scorer(user_embs.reshape(B * K, D))
                merged, counts = batched_merge_multi_interest_np(
                    ids.cpu().numpy().reshape(B, -1), scores.cpu().numpy().reshape(B, -1), topn)
                for i, u in enumerate(users):
                    preds[str(u)] = merged[i, :counts[i]].tolist()
    return preds


def evaluate_recall(preds: Dict[str, List[int]], test_gd: Dict[str, List[int]],
                    topn: int = 50) -> Dict[str, float]:
    total_recall = 0.0
    total_ndcg = 0.0
    total_hitrate = 0
    for user, item_list in test_gd.items():
        if user not in preds:
            continue
        topk = list(preds[user][:topn])
        recall = 0
        dcg = 0.0
        for item_id in item_list:
            if item_id in topk:
                recall += 1
                dcg += 1.0 / math.log2(topk.index(item_id) + 2)
        # the reference's quirk: idcg from the FINAL hit count
        idcg = sum(1.0 / math.log2(no + 2) for no in range(recall))
        total_recall += recall * 1.0 / len(item_list)
        if recall > 0:
            total_ndcg += dcg / idcg
            total_hitrate += 1
    total = len(test_gd)
    return {
        f"recall@{topn}": round(total_recall / total, 4),
        f"ndcg@{topn}": round(total_ndcg / total, 4),
        f"hitrate@{topn}": round(total_hitrate * 1.0 / total, 4),
    }
