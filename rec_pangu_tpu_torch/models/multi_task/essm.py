"""ESSM: a CTR and a CVR MLP over the flattened sparse embeddings only
(the reference ignores the dense features); the loss is
``BCE(pCTR * pCVR, task2) + 0.5 * BCE(pCTR, task1)``."""
from __future__ import annotations

from typing import Sequence

import torch

from ...convert import prefixed
from ...ops.embedding import FusedEmbedding
from ...ops.mlp import MLP
from ..base import register_model
from ..losses import bce_loss
from .common import MultiTaskBase


@register_model("ESSM")
class ESSM(MultiTaskBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 40,
                 hidden_dim: Sequence[int] = (128, 64), dropouts: Sequence[float] = (0.2, 0.2),
                 seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        fan_in = self.num_sparse * self.embedding_dim
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, init_mode="xavier",
                                        generator=gen)
        self.ctr_layer, self.cvr_layer = (
            MLP(fan_in, hidden_dim, output_dim=1, hidden_activations="relu",
                dropout_rates=list(dropouts), generator=gen, dropout_stream=s, init="xavier")
            for s in (0, 1))

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)
        hidden = emb.reshape(emb.shape[0], -1)
        click = torch.sigmoid(self.ctr_layer(hidden, train, seed))[:, 0]
        conversion = torch.sigmoid(self.cvr_layer(hidden, train, seed))[:, 0]
        return self.outputs([click, conversion], batch, train)

    def loss_of(self, preds, labels):
        click, conversion = preds
        return bce_loss(click * conversion, labels[:, 1]) + 0.5 * bce_loss(click, labels[:, 0])

    def jax_leaves(self):
        return (prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                + prefixed("ctr_layer", self.ctr_layer.jax_leaves())
                + prefixed("cvr_layer", self.cvr_layer.jax_leaves()))
