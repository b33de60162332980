"""OMOE: a shared expert bank mixed by ONE input-independent softmax gate
(``gate`` [E, 1], softmax over the experts), then a ``TaskTower`` per task
over the same mix."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...convert import prefixed
from ...ops.embedding import FusedEmbedding
from ..base import register_model
from .common import (ExpertBank, MultiTaskBase, normal_init, tower_leaves, towers,
                     uniform_init)


@register_model("OMOE")
class OMOE(MultiTaskBase):
    def __init__(self, enc_dict: dict, num_task: int = 2, n_expert: int = 3,
                 embedding_dim: int = 40, omoe_hidden_dim: int = 128,
                 expert_activation: Optional[str] = None,
                 hidden_dim: Sequence[int] = (128, 64), dropouts: Sequence[float] = (0.2, 0.2),
                 seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.num_task = int(num_task)
        self.embedding_dim = int(embedding_dim)
        H = self.dnn_input_dim(self.embedding_dim)
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, init_mode="xavier",
                                        generator=gen)
        self.experts = ExpertBank(H, omoe_hidden_dim, n_expert, normal_init, gen,
                                  expert_activation)
        self.gate = uniform_init((n_expert, 1), gen)
        self.towers = towers(omoe_hidden_dim, self.num_task, hidden_dim, dropouts, gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)
        hidden = torch.cat([emb.reshape(emb.shape[0], -1), batch["dense"]], dim=1)
        gate = torch.softmax(self.gate, dim=0)                       # [E, 1]
        gate_out = torch.matmul(self.experts(hidden), gate)[..., 0]  # [B, M]
        return self.outputs([tower(gate_out, train, seed) for tower in self.towers], batch,
                            train)

    def jax_leaves(self):
        return (prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                + self.experts.jax_leaves() + [("params", ("gate",), self.gate, False)]
                + tower_leaves(self.towers))
