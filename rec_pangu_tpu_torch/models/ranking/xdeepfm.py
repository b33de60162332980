"""xDeepFM: LR + CIN + an MLP (the MLP's defaults: relu, dropout 0.1),
summed logits."""
from __future__ import annotations

from typing import Sequence

import torch

from ...convert import prefixed
from ...ops.embedding import FusedEmbedding, LRLayer
from ...ops.interactions import CompressedInteractionNet
from ...ops.mlp import MLP
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


@register_model("xDeepFM")
class xDeepFM(RankModelBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32,
                 dnn_hidden_units: Sequence[int] = (64, 64, 64),
                 cin_layer_units: Sequence[int] = (16, 16, 16), loss_fun: str = "bce",
                 seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        self.loss_fn = get_loss_fn(loss_fun)
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, generator=gen)
        self.lr_layer = LRLayer(self.spec, gen)
        self.cin = CompressedInteractionNet(self.num_sparse, cin_layer_units, 1, gen)
        self.mlp = MLP(self.dnn_input_dim(self.embedding_dim), dnn_hidden_units, output_dim=1,
                       generator=gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)
        lr_logit = self.lr_layer(batch["sparse"], batch["dense"], capture)
        dnn_input = torch.cat([emb.reshape(emb.shape[0], -1), batch["dense"]], dim=1)
        logit = lr_logit + self.cin(emb) + self.mlp(dnn_input, train, seed)
        return self.outputs(torch.sigmoid(logit), batch, train)

    def jax_leaves(self):
        return (prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                + prefixed("LRLayer_0", self.lr_layer.jax_leaves())
                + prefixed("CompressedInteractionNet_0", self.cin.jax_leaves())
                + prefixed("MLP_0", self.mlp.jax_leaves()))
