"""FiBiNet: LR + an MLP over the bilinear interactions of the raw and the
SENET-reweighted embeddings (one bilinear module for both)."""
from __future__ import annotations

from typing import Sequence

import torch

from ...convert import prefixed
from ...ops.embedding import FusedEmbedding, LRLayer
from ...ops.interactions import BilinearInteraction, SENETLayer
from ...ops.mlp import MLP
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


@register_model("FiBiNet")
class FiBiNet(RankModelBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32,
                 hidden_units: Sequence[int] = (64, 64, 64), loss_fun: str = "bce",
                 seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        self.loss_fn = get_loss_fn(loss_fun)
        F = self.num_sparse
        self.lr_layer = LRLayer(self.spec, gen)
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, generator=gen)
        self.senet = SENETLayer(F, 3, gen)
        self.bilinear = BilinearInteraction(F, self.embedding_dim, "field_interaction", gen)
        pairs = F * (F - 1) // 2
        self.mlp = MLP(2 * pairs * self.embedding_dim + self.num_dense, hidden_units,
                       output_dim=1, dropout_rates=0.0, generator=gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        lr_logit = self.lr_layer(batch["sparse"], batch["dense"], capture)
        emb = self.embedding(batch["sparse"], capture)
        p = self.bilinear(emb)
        q = self.bilinear(self.senet(emb))
        comb = torch.cat([p, q], dim=1).reshape(emb.shape[0], -1)
        dnn_logit = self.mlp(torch.cat([comb, batch["dense"]], dim=1), train, seed)
        return self.outputs(torch.sigmoid(lr_logit + dnn_logit), batch, train)

    def jax_leaves(self):
        return (prefixed("LRLayer_0", self.lr_layer.jax_leaves())
                + prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                + prefixed("SENETLayer_0", self.senet.jax_leaves())
                + prefixed("BilinearInteraction_0", self.bilinear.jax_leaves())
                + prefixed("MLP_0", self.mlp.jax_leaves()))
