"""Model base class and registry.

A ranking model is an ``nn.Module`` whose ``forward(batch, train=False)``
takes a dict of tensors ``{'sparse': [B, F] i32, 'dense': [B, Nd] f32}``
and returns ``{'pred': [B, 1]}``, plus ``'loss'`` when ``train`` and a
label are given.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..data.encoder import FeatureSpec
from ..ops.embedding import check_ids

MODEL_REGISTRY: Dict[str, type] = {}


def register_model(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        MODEL_REGISTRY[name] = cls
        MODEL_REGISTRY[name.lower()] = cls
        return cls

    return deco


def get_model(name: str) -> type:
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if name.lower() in MODEL_REGISTRY:
        return MODEL_REGISTRY[name.lower()]
    raise KeyError(f"Unknown model {name!r}; registered: "
                   f"{sorted(k for k in MODEL_REGISTRY if not k.islower())}")


class RankModelBase(nn.Module):
    """Children build their layers in ``__init__`` from ``enc_dict`` and
    list their weights under flax names in ``jax_leaves``."""

    # batch keys the model reads, with their types; the rest stay on the host
    input_dtypes = {"sparse": np.int32, "dense": np.float32}

    def __init__(self, enc_dict: dict):
        super().__init__()
        self.enc_dict = enc_dict
        self.spec = FeatureSpec.from_enc_dict(enc_dict)

    @property
    def num_sparse(self) -> int:
        return self.spec.num_sparse

    @property
    def num_dense(self) -> int:
        return self.spec.num_dense

    def dnn_input_dim(self, embedding_dim: int) -> int:
        return self.num_sparse * embedding_dim + self.num_dense

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        raise NotImplementedError

    def upload_batch(self, batch: Dict[str, np.ndarray],
                     device: torch.device) -> Dict[str, torch.Tensor]:
        """Check a host batch's ids against the table (ValueError before any
        upload) and copy the keys the model reads to ``device``."""
        check_ids(self.spec, batch["sparse"], self.embedding.table.shape[0])
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k], dtype=dt)).to(device)
                for k, dt in self.input_dtypes.items()}
