"""AITM: a click tower and a conversion tower (MLPs), the click tower's
information carried to the conversion side by a Dense -> relu -> Dropout
and a one-head self-attention over [conversion, info] (summed), each
tower's Dense(1) -> sigmoid.  The loss adds the calibration constraint
``constraint_weight * sum(max(pCVR - pCTR, 0))`` (0.6) to both BCEs."""
from __future__ import annotations

from typing import Sequence

import torch

from ...convert import prefixed
from ...ops.attention import MultiHeadSelfAttention
from ...ops.dropout import AITM_INFO_DROPOUT, draw_seed, feature_dropout
from ...ops.embedding import FusedEmbedding
from ...ops.mlp import MLP
from ...ops.sequence_enc import _dense, _linear_leaves
from ..base import register_model
from ..losses import bce_loss
from .common import MultiTaskBase


@register_model("AITM")
class AITM(MultiTaskBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32,
                 tower_dims: Sequence[int] = (400, 400, 400),
                 drop_prob: Sequence[float] = (0.1, 0.1, 0.1), constraint_weight: float = 0.6,
                 seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        self.drop_prob = [float(p) for p in drop_prob]
        self.constraint_weight = float(constraint_weight)
        fan_in, dim = self.num_sparse * self.embedding_dim, int(tower_dims[-1])
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, init_mode="xavier",
                                        generator=gen)
        self.click_tower, self.conversion_tower = (
            MLP(fan_in, tower_dims, hidden_activations="relu", dropout_rates=self.drop_prob,
                generator=gen, dropout_stream=s, init="xavier") for s in (0, 1))
        self.Dense_0 = _dense(dim, dim, gen, init="xavier")
        self.attention_layer = MultiHeadSelfAttention(dim, generator=gen, init="xavier")
        self.click_layer = _dense(dim, 1, gen, init="xavier")
        self.conversion_layer = _dense(dim, 1, gen, init="xavier")

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        if train and seed is None:
            seed = draw_seed()
        emb = self.embedding(batch["sparse"], capture)
        feat = emb.reshape(emb.shape[0], -1)
        tower_click = self.click_tower(feat, train, seed)
        tower_conv = self.conversion_tower(feat, train, seed)
        info = torch.relu(self.Dense_0(tower_click))
        if train:
            info = feature_dropout(info, self.drop_prob[-1], seed, AITM_INFO_DROPOUT)
        ait = self.attention_layer(torch.stack([tower_conv, info], dim=1), train, seed).sum(1)
        click = torch.sigmoid(self.click_layer(tower_click))[:, 0]
        conversion = torch.sigmoid(self.conversion_layer(ait))[:, 0]
        return self.outputs([click, conversion], batch, train)

    def loss_of(self, preds, labels):
        click, conversion = preds
        constraint = torch.clamp(conversion - click, min=0.0).sum()
        return (bce_loss(click, labels[:, 0]) + bce_loss(conversion, labels[:, 1])
                + self.constraint_weight * constraint)

    def jax_leaves(self):
        return (prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                + prefixed("click_tower", self.click_tower.jax_leaves())
                + prefixed("conversion_tower", self.conversion_tower.jax_leaves())
                + _linear_leaves(self, ("Dense_0", "click_layer", "conversion_layer"))
                + prefixed("attention_layer", self.attention_layer.jax_leaves()))
