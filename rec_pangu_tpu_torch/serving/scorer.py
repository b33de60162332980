"""Serving scorers.

* ``make_ranking_scorer``: a host batch {'sparse', 'dense'} -> [B]
  probabilities.
* ``make_retrieval_scorer``: a host batch of histories -> the top-k items of
  the whole corpus, (scores, ids) on the host.

Each scorer checks the ids on the host (ValueError before any upload),
uploads the batch, runs the model under ``torch.inference_mode()`` and
returns its answer on the host.  The lookup kernel needs no host sort plan,
so none is built.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..data.encoder import FeatureSpec
from ..eval.retrieval import l2_normalize
from ..utils.device import DeviceLike, resolve_device


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

    def score(batch: Dict[str, np.ndarray]) -> np.ndarray:
        inputs = model.upload_batch(batch, dev)
        with torch.inference_mode():
            pred = model(inputs, train=False)["pred"]
        return pred.reshape(-1).cpu().numpy()

    return score


def make_retrieval_scorer(model, topk: int = 200, normalize: bool = True,
                          device: DeviceLike = None
                          ) -> Callable[[Dict[str, np.ndarray]], Tuple[np.ndarray, np.ndarray]]:
    """Move a sequence model to ``device`` in eval mode and return its
    retriever: {'hist_item_list', 'hist_mask_list'} -> (scores [B, topk] f32,
    item ids [B, topk] int32), best first.  The corpus (``output_items``,
    L2-normalized when ``normalize``) is computed once, here; a request runs
    the model, normalizes its user embeddings, scores them against the corpus
    with one matmul and takes ``torch.topk``.  A multi-interest model's
    score for an item is its best over the interests."""
    dev = resolve_device(device)
    model.to(dev).eval()
    with torch.inference_mode():
        items = model.output_items()
        if normalize:
            items = l2_normalize(items)

    def retrieve(batch: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        inputs = model.upload_batch(batch, dev)
        with torch.inference_mode():
            user_emb = model(inputs, train=False)["user_emb"]
            u = l2_normalize(user_emb) if normalize else user_emb
            if u.dim() == 3:
                scores = torch.einsum("bkd,nd->bkn", u, items).amax(dim=1)
            else:
                scores = torch.matmul(u, items.T)
            top, ids = torch.topk(scores, topk, dim=-1)
            ids = ids.to(torch.int32)
        return top.cpu().numpy(), ids.cpu().numpy()

    return retrieve
