"""Ranking scorer: a host batch {'sparse', 'dense'} -> [B] probabilities.

The scorer checks the ids on the host (ValueError before any upload),
uploads the batch, runs the model under ``torch.inference_mode()`` and
returns the predictions on the host.  The lookup kernel needs no host sort
plan, so none is built.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..data.encoder import FeatureSpec
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
