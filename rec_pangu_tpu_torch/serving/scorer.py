"""Serving scorers.

* ``make_ranking_scorer``: a host batch {'sparse', 'dense'} -> [B]
  probabilities.
* ``make_retrieval_scorer``: a host batch of histories -> the top-k items of
  the whole corpus, (scores, ids) on the host.

Each scorer checks the ids on the host (ValueError before any upload),
uploads the batch, runs the model under ``torch.inference_mode()`` and
returns its answer on the host.  The lookup kernel needs no host sort plan,
so none is built.  A request is the top-level span ``serve.request``
(``utils/trace.py``), numbered by the scorer's count of requests; the
retriever's model forward and normalization are ``serve.encode``, its
scoring product ``serve.score`` and its top-k ``serve.select``.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..data.encoder import FeatureSpec
from ..eval.retrieval import l2_normalize
from ..ops.kernels.row_topk import row_topk
from ..utils.device import DeviceLike, resolve_device
from ..utils.trace import span


def construct_dummy_data(enc_dict: dict, batch_size: int = 2) -> Dict[str, np.ndarray]:
    """Schema-shaped zero batch."""
    spec = FeatureSpec.from_enc_dict(enc_dict)
    return {
        "sparse": np.zeros((batch_size, spec.num_sparse), np.int32),
        "dense": np.zeros((batch_size, spec.num_dense), np.float32),
    }


def make_ranking_scorer(model, device: DeviceLike = None
                        ) -> Callable[[Dict[str, np.ndarray]], np.ndarray]:
    """Move ``model`` to ``device`` in eval mode and return its batch scorer."""
    dev = resolve_device(device)
    model.to(dev).eval()
    requests = itertools.count()

    def score(batch: Dict[str, np.ndarray]) -> np.ndarray:
        with span("serve.request", next(requests), dev):
            inputs = model.upload_batch(batch, dev)
            with torch.inference_mode():
                pred = model(inputs, train=False)["pred"]
            return pred.reshape(-1).cpu().numpy()

    return score


def score_items(user_embs: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """[B, N] scores of users [B, D] against items [N, D]; for a
    multi-interest model's [B, K, D], each item's best over the interests:
    one matmul an interest, kept as a running maximum in one [B, N] buffer
    (the max is exact, so these are the bits of the max over a [B, K, N]
    tensor, which at 1024 users x 4 interests x 1,000,000 items would take
    16 GB)."""
    if user_embs.dim() == 2:
        return torch.matmul(user_embs, items.T)
    scores = torch.matmul(user_embs[:, 0], items.T)
    interest = torch.empty_like(scores)
    for k in range(1, user_embs.shape[1]):
        torch.maximum(scores, torch.matmul(user_embs[:, k], items.T, out=interest), out=scores)
    return scores


def make_retrieval_scorer(model, topk: int = 200, normalize: bool = True,
                          device: DeviceLike = None
                          ) -> Callable[[Dict[str, np.ndarray]], Tuple[np.ndarray, np.ndarray]]:
    """Move a sequence model to ``device`` in eval mode and return its
    retriever: {'hist_item_list', 'hist_mask_list'} -> (scores [B, topk] f32,
    item ids [B, topk] int32), best first.  The corpus (``output_items``,
    L2-normalized when ``normalize``) is computed once, here; a request runs
    the model, normalizes its user embeddings, scores them against the corpus
    with one matmul and takes each row's top-k (``ops/kernels/row_topk``:
    exact, ties to the smallest ids).  A multi-interest model's score for an
    item is its best over the interests (``score_items``)."""
    dev = resolve_device(device)
    model.to(dev).eval()
    with torch.inference_mode():
        items = model.output_items()
        if normalize:
            items = l2_normalize(items)

    requests = itertools.count()

    def retrieve(batch: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        with span("serve.request", next(requests), dev):
            inputs = model.upload_batch(batch, dev)
            with torch.inference_mode():
                with span("serve.encode"):
                    user_emb = model(inputs, train=False)["user_emb"]
                    u = l2_normalize(user_emb) if normalize else user_emb
                with span("serve.score"):
                    scores = score_items(u, items)
                with span("serve.select"):
                    top, ids = row_topk(scores, topk)
                del scores  # the [B, V] scores (4 GB at 1 M items) go before the copies back
            return top.cpu().numpy(), ids.cpu().numpy()

    return retrieve
