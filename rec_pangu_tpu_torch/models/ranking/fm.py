"""FM: the pairwise-interaction logit alone (no wide part, as in the
reference)."""
from __future__ import annotations

import torch

from ...convert import prefixed
from ...ops.embedding import FusedEmbedding
from ...ops.interactions import inner_product
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


@register_model("FM")
class FM(RankModelBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32, loss_fun: str = "bce",
                 seed: int = 1029):
        super().__init__(enc_dict)
        self.embedding_dim = int(embedding_dim)
        self.loss_fn = get_loss_fn(loss_fun)
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim,
                                        generator=torch.Generator().manual_seed(seed))

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)
        return self.outputs(torch.sigmoid(inner_product(emb, "product_sum_pooling")), batch,
                            train)

    def jax_leaves(self):
        return prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
