"""LR: the wide (linear) part alone."""
from __future__ import annotations

import torch

from ...convert import prefixed
from ...ops.embedding import LRLayer
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


@register_model("LR")
class LR(RankModelBase):
    def __init__(self, enc_dict: dict, loss_fun: str = "bce", seed: int = 1029):
        super().__init__(enc_dict)
        self.loss_fn = get_loss_fn(loss_fun)
        self.lr_layer = LRLayer(self.spec, torch.Generator().manual_seed(seed))

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        logit = self.lr_layer(batch["sparse"], batch["dense"], capture)
        return self.outputs(torch.sigmoid(logit), batch, train)

    def jax_leaves(self):
        return prefixed("LRLayer_0", self.lr_layer.jax_leaves())
