"""AutoInt: stacked multi-head self-attention over the field embeddings ->
Dense(1), plus an MLP (dropout 0.1) and LR, summed."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...convert import prefixed
from ...ops.attention import MultiHeadSelfAttention
from ...ops.embedding import FusedEmbedding, LRLayer
from ...ops.mlp import MLP
from ...ops.sequence_enc import _dense, _linear_leaves
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


@register_model("AutoInt")
class AutoInt(RankModelBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32,
                 dnn_hidden_units: Sequence[int] = (64, 64, 64), attention_layers: int = 1,
                 num_heads: int = 1, attention_dim: int = 8, loss_fun: str = "bce",
                 seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        self.loss_fn = get_loss_fn(loss_fun)
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, generator=gen)
        widths = [self.embedding_dim] + [attention_dim * num_heads] * attention_layers
        self.attention = nn.ModuleList(
            MultiHeadSelfAttention(widths[i], attention_dim, num_heads, align_to="output",
                                   block=i, generator=gen)
            for i in range(attention_layers))
        self.Dense_0 = _dense(self.num_sparse * widths[-1], 1, gen)
        self.mlp = MLP(self.dnn_input_dim(self.embedding_dim), dnn_hidden_units, output_dim=1,
                       generator=gen)
        self.lr_layer = LRLayer(self.spec, gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)
        att = emb
        for layer in self.attention:
            att = layer(att, train, seed)
        logit = self.Dense_0(att.reshape(att.shape[0], -1))
        dnn_input = torch.cat([emb.reshape(emb.shape[0], -1), batch["dense"]], dim=1)
        logit = logit + self.mlp(dnn_input, train, seed)
        logit = logit + self.lr_layer(batch["sparse"], batch["dense"], capture)
        return self.outputs(torch.sigmoid(logit), batch, train)

    def jax_leaves(self):
        leaves = prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
        for i, layer in enumerate(self.attention):
            leaves += prefixed(f"MultiHeadSelfAttention_{i}", layer.jax_leaves())
        return (leaves + _linear_leaves(self, ("Dense_0",))
                + prefixed("MLP_0", self.mlp.jax_leaves())
                + prefixed("LRLayer_0", self.lr_layer.jax_leaves()))
