"""AFM, the Attentional Factorization Machine (Xiao et al. 2017), as the JAX
package implements it (the reference's afm.py is a FiBiNet clone): LR plus
the attention-pooled pairwise products,
``a_ij = softmax(h^T relu(W (e_i * e_j) + b))``, ``logit += p^T sum a_ij
(e_i * e_j)``.  The attention's dropout draws the port's hash masks on
``AFM_DROPOUT``."""
from __future__ import annotations

import torch

from ...convert import prefixed
from ...ops.dropout import AFM_DROPOUT, draw_seed, feature_dropout
from ...ops.embedding import FusedEmbedding, LRLayer
from ...ops.interactions import inner_product
from ...ops.sequence_enc import _dense, _linear_leaves
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


@register_model("AFM")
class AFM(RankModelBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32, attention_dim: int = 32,
                 dropout_rate: float = 0.0, loss_fun: str = "bce", seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        self.dropout_rate = float(dropout_rate)
        self.loss_fn = get_loss_fn(loss_fun)
        self.lr_layer = LRLayer(self.spec, gen)
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, generator=gen)
        self.Dense_0 = _dense(self.embedding_dim, attention_dim, gen)
        self.Dense_1 = _dense(attention_dim, 1, gen, bias=False)
        self.Dense_2 = _dense(self.embedding_dim, 1, gen, bias=False)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        lr_logit = self.lr_layer(batch["sparse"], batch["dense"], capture)
        emb = self.embedding(batch["sparse"], capture)
        pairs = inner_product(emb, "elementwise_product")                # [B, P, D]
        att = torch.softmax(self.Dense_1(torch.relu(self.Dense_0(pairs))), dim=1)
        if train and self.dropout_rate > 0:
            seed = draw_seed() if seed is None else seed
            att = feature_dropout(att, self.dropout_rate, seed, AFM_DROPOUT)
        afm_logit = self.Dense_2((att * pairs).sum(dim=1))
        return self.outputs(torch.sigmoid(lr_logit + afm_logit), batch, train)

    def jax_leaves(self):
        return (prefixed("LRLayer_0", self.lr_layer.jax_leaves())
                + prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                + _linear_leaves(self, ("Dense_0", "Dense_1", "Dense_2")))
