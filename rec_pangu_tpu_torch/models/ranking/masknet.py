"""MaskNet: MaskBlocks over [flattened embeddings ++ dense], in parallel
(averaged) or in series, -> an MLP (dropout 0.1)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...convert import prefixed
from ...ops.embedding import FusedEmbedding
from ...ops.interactions import MaskBlock
from ...ops.mlp import MLP
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


@register_model("MaskNet")
class MaskNet(RankModelBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32, block_num: int = 3,
                 use_parallel: bool = True, reduction_factor: float = 0.3,
                 hidden_units: Sequence[int] = (64, 64, 64), loss_fun: str = "bce",
                 seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        self.loss_fn = get_loss_fn(loss_fun)
        self.use_parallel = bool(use_parallel)
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, generator=gen)
        width = self.dnn_input_dim(self.embedding_dim)
        self.blocks = nn.ModuleList(MaskBlock(width, width, width, reduction_factor, gen)
                                    for _ in range(block_num))
        self.mlp = MLP(width, hidden_units, output_dim=1, generator=gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)
        x = torch.cat([emb.reshape(emb.shape[0], -1), batch["dense"]], dim=1)
        if self.use_parallel:
            out = torch.stack([blk(x, x) for blk in self.blocks], dim=1).mean(dim=1)
        else:
            out = x
            for blk in self.blocks:
                out = blk(out, x)
        return self.outputs(torch.sigmoid(self.mlp(out, train, seed)), batch, train)

    def jax_leaves(self):
        leaves = prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
        for i, blk in enumerate(self.blocks):
            leaves += prefixed(f"MaskBlock_{i}", blk.jax_leaves())
        return leaves + prefixed("MLP_0", self.mlp.jax_leaves())
