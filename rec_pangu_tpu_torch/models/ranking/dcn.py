"""DCN: a CrossNet over [flattened embeddings ++ dense] -> Dense(1).
``hidden_units`` is kept for the reference's signature; its forward does not
use it."""
from __future__ import annotations

from typing import Sequence

import torch

from ...convert import prefixed
from ...ops.embedding import FusedEmbedding
from ...ops.interactions import CrossNet
from ...ops.sequence_enc import _dense, _linear_leaves
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


@register_model("DCN")
class DCN(RankModelBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32,
                 hidden_units: Sequence[int] = (64, 64, 64), crossing_layers: int = 3,
                 loss_fun: str = "bce", seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        self.loss_fn = get_loss_fn(loss_fun)
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, generator=gen)
        width = self.dnn_input_dim(self.embedding_dim)
        self.cross = CrossNet(width, crossing_layers, gen)
        self.Dense_0 = _dense(width, 1, gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)
        x0 = torch.cat([emb.reshape(emb.shape[0], -1), batch["dense"]], dim=1)
        return self.outputs(torch.sigmoid(self.Dense_0(self.cross(x0))), batch, train)

    def jax_leaves(self):
        return (prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                + prefixed("CrossNet_0", self.cross.jax_leaves())
                + _linear_leaves(self, ("Dense_0",)))
