"""ShareBottom: the flattened embeddings and the dense features, shared,
into one ``TaskTower`` per task."""
from __future__ import annotations

from typing import Sequence

import torch

from ...convert import prefixed
from ...ops.embedding import FusedEmbedding
from ..base import register_model
from .common import MultiTaskBase, tower_leaves, towers


@register_model("ShareBottom")
class ShareBottom(MultiTaskBase):
    def __init__(self, enc_dict: dict, num_task: int = 2, embedding_dim: int = 40,
                 hidden_units: Sequence[int] = (128, 64),
                 dropouts: Sequence[float] = (0.2, 0.2), seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.num_task = int(num_task)
        self.embedding_dim = int(embedding_dim)
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, init_mode="xavier",
                                        generator=gen)
        self.towers = towers(self.dnn_input_dim(self.embedding_dim), self.num_task,
                             hidden_units, dropouts, gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)
        hidden = torch.cat([emb.reshape(emb.shape[0], -1), batch["dense"]], dim=1)
        return self.outputs([tower(hidden, train, seed) for tower in self.towers], batch, train)

    def jax_leaves(self):
        return (prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                + tower_leaves(self.towers))
