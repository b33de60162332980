"""NextItNet: the dilated causal convolution stack over the history
(``ops/conv.NextItNetLayer``), the JAX package's
``models/sequence/nextitnet.py``, its weights under the same flax names
(``nextit_layer/ResBlockTwoMasked_{j}/...``, or ``ResBlockOneMasked_{j}``
with ``one_masked``).  ``feat_drop`` (0 by default) draws the fused
encoder's hash masks on a stream of its own."""
from __future__ import annotations

import torch

from ...ops.conv import NextItNetLayer
from ...ops.sequence_enc import step_seed
from ..base import SequenceModelBase, register_model


@register_model("NextItNet")
class NextItNet(SequenceModelBase):
    fused_update_compatible = True

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        cfg = self.config
        self.nextit_layer = NextItNetLayer(
            self.embedding_dim, dilations=cfg.get("dilations", None),
            one_masked=bool(cfg.get("one_masked", False)),
            kernel_size=int(cfg.get("kernel_size", 3)),
            feat_drop=float(cfg.get("feat_drop", 0)), generator=self.generator)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...], "ce": [...]} lists;
        ``seed``: the step's seed (see SequenceModelBase)."""
        capture = capture or {}
        lengths = batch["hist_mask_list"].sum(dim=-1).to(torch.int64)
        seq_emb = self.item_emb(batch["hist_item_list"], capture.get("hist"))
        if train:
            seed = step_seed(seed)
        user_emb = self.nextit_layer(seq_emb, lengths, train, seed or 0)
        out = {"user_emb": user_emb}
        if train:
            out["loss"] = self.calculate_loss(user_emb, batch["target_item"],
                                              capture.get("ce"), seed)
        return out

    def jax_leaves(self):
        return ([(c, ("item_emb",) + p, t, tr) for c, p, t, tr in self.item_emb.jax_leaves()]
                + [(c, ("nextit_layer",) + p, t, tr)
                   for c, p, t, tr in self.nextit_layer.jax_leaves()])
