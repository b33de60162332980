"""MLMMOE: two-level gating.  The expert bank's outputs are remixed by E
input-independent level gates (``level_gates`` [E, E], a softmax over the
source axis: ``level_out[:, :, d] = experts_out @ softmax(G)[d]``), then
each task's input-dependent gate mixes the level outputs into its
``TaskTower``, as in MMOE."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...convert import prefixed
from ...ops.embedding import FusedEmbedding
from ..base import register_model
from .common import (ExpertBank, MultiTaskBase, TaskGates, mix, normal_init, tower_leaves,
                     towers, uniform_init)


@register_model("MLMMOE")
class MLMMOE(MultiTaskBase):
    def __init__(self, enc_dict: dict, num_task: int = 2, n_expert: int = 3,
                 embedding_dim: int = 40, mmoe_hidden_dim: int = 128,
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
        self.experts = ExpertBank(H, mmoe_hidden_dim, n_expert, normal_init, gen,
                                  expert_activation)
        self.level_gates = uniform_init((n_expert, n_expert), gen)
        self.gates = TaskGates(H, n_expert, self.num_task, gen)
        self.towers = towers(mmoe_hidden_dim, self.num_task, hidden_dim, dropouts, gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)
        hidden = torch.cat([emb.reshape(emb.shape[0], -1), batch["dense"]], dim=1)
        G = torch.softmax(self.level_gates, dim=1)                   # [E_out, E_in]
        level_out = torch.matmul(self.experts(hidden), G.t())        # [B, M, E_out]
        preds = [tower(mix(level_out, self.gates(hidden, i)), train, seed)
                 for i, tower in enumerate(self.towers)]
        return self.outputs(preds, batch, train)

    def jax_leaves(self):
        return (prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                + self.experts.jax_leaves()
                + [("params", ("level_gates",), self.level_gates, False)]
                + self.gates.jax_leaves() + tower_leaves(self.towers))
