"""DeepFM: fused embedding -> FM pairwise logit + MLP over
[flattened embeddings ++ dense] -> sigmoid(sum)."""
from __future__ import annotations

from typing import Sequence

import torch

from ...ops.embedding import FusedEmbedding
from ...ops.interactions import inner_product
from ...ops.mlp import MLP
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


@register_model("DeepFM")
class DeepFM(RankModelBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32,
                 hidden_units: Sequence[int] = (64, 64, 64), loss_fun: str = "bce",
                 seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        self.loss_fn = get_loss_fn(loss_fun)
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, generator=gen)
        self.mlp = MLP(self.dnn_input_dim(self.embedding_dim), hidden_units,
                       output_dim=1, hidden_activations="relu", dropout_rates=0.0,
                       generator=gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)             # [B, F, D]
        fm_logit = inner_product(emb, "product_sum_pooling")       # [B, 1]
        dnn_input = torch.cat([emb.reshape(emb.shape[0], -1), batch["dense"]], dim=1)
        y_pred = torch.sigmoid(fm_logit + self.mlp(dnn_input, train, seed))
        out = {"pred": y_pred}
        if train and "label" in batch:
            out["loss"] = self.loss_fn(y_pred, batch["label"])
        return out

    def jax_leaves(self):
        return ([(c, ("FusedEmbedding_0",) + p, t, tr)
                 for c, p, t, tr in self.embedding.jax_leaves()]
                + [(c, ("MLP_0",) + p, t, tr) for c, p, t, tr in self.mlp.jax_leaves()])
