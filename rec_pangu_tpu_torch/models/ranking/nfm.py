"""NFM: LR + an MLP over the Bi-interaction pooling."""
from __future__ import annotations

from typing import Sequence

import torch

from ...convert import prefixed
from ...ops.embedding import FusedEmbedding, LRLayer
from ...ops.interactions import inner_product
from ...ops.mlp import MLP
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


@register_model("NFM")
class NFM(RankModelBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32,
                 hidden_units: Sequence[int] = (64, 64, 64), loss_fun: str = "bce",
                 seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        self.loss_fn = get_loss_fn(loss_fun)
        self.lr_layer = LRLayer(self.spec, gen)
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, generator=gen)
        self.mlp = MLP(self.embedding_dim, hidden_units, output_dim=1, dropout_rates=0.0,
                       generator=gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        lr_logit = self.lr_layer(batch["sparse"], batch["dense"], capture)
        emb = self.embedding(batch["sparse"], capture)
        dnn_logit = self.mlp(inner_product(emb, "Bi_interaction_pooling"), train, seed)
        return self.outputs(torch.sigmoid(lr_logit + dnn_logit), batch, train)

    def jax_leaves(self):
        return (prefixed("LRLayer_0", self.lr_layer.jax_leaves())
                + prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                + prefixed("MLP_0", self.mlp.jax_leaves()))
