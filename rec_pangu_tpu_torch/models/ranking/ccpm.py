"""CCPM: zero-pad + convolution + k-max pooling + tanh stack over the field
axis -> Dense(1).  ``hidden_units`` is kept for the reference's signature;
its forward does not use it."""
from __future__ import annotations

from typing import Sequence

import torch

from ...convert import prefixed
from ...ops.conv import CCPMConvLayer
from ...ops.embedding import FusedEmbedding
from ...ops.sequence_enc import _dense, _linear_leaves
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


@register_model("CCPM")
class CCPM(RankModelBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32,
                 hidden_units: Sequence[int] = (64, 64, 64),
                 channels: Sequence[int] = (4, 4, 2),
                 kernel_heights: Sequence[int] = (6, 5, 3), loss_fun: str = "bce",
                 seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        self.loss_fn = get_loss_fn(loss_fun)
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, generator=gen)
        self.conv = CCPMConvLayer(self.num_sparse, channels, kernel_heights, gen)
        self.Dense_0 = _dense(3 * self.embedding_dim * channels[-1], 1, gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)
        conv_out = self.conv(emb)                                       # [B, 3, D, C]
        logit = self.Dense_0(conv_out.reshape(conv_out.shape[0], -1))
        return self.outputs(torch.sigmoid(logit), batch, train)

    def jax_leaves(self):
        return (prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                + prefixed("CCPMConvLayer_0", self.conv.jax_leaves())
                + _linear_leaves(self, ("Dense_0",)))
