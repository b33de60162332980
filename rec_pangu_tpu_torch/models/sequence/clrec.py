"""CLRec: the BERT4Rec encoder, the full-softmax CE and an InfoNCE of each
user against its target item.

The JAX package's ``models/sequence/clrec.py``, its weights under the same
flax names (``jax_leaves``).  In training the history and the target item
are read by one lookup of ``lookup_all = [hist | target]`` [B, L + 1],
which the trainer builds on the host (``lookup_extra``), so the sequence
fused step captures every gradient-carrying read of the table; a training
batch without it takes a history lookup and a target lookup.  On the card
the lookup is K1 and the encoder K4f (K4b backward).
"""
from __future__ import annotations

import torch

from ...ops.numerics import safe_l2norm
from ...ops.sequence_enc import BERT4RecEncoder
from ..base import SequenceModelBase, register_model
from .contra_losses import clrec_contra_loss


@register_model("CLRec")
class CLRec(SequenceModelBase):
    fused_update_compatible = True
    fused_lookup_key = "lookup_all"     # [hist | target]: the fused step's ids
    lookup_extra = ("target_item",)     # what the trainer appends to the histories

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        self.temp = float(self.config.get("temp", 0.1))
        self.encoder = BERT4RecEncoder(self.max_length, self.embedding_dim, num_layers=2,
                                       num_heads=2, generator=self.generator)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...], "ce": [...]} lists;
        ``seed``: the step's seed (see SequenceModelBase)."""
        hist = batch["hist_item_list"]
        lengths = batch["hist_mask_list"].sum(dim=-1).to(torch.int64)
        L = hist.shape[1]
        capture = capture or {}
        target_emb = None
        if train and "lookup_all" in batch:
            emb = self.item_emb(batch["lookup_all"], capture.get("hist"))
            seq_emb, target_emb = emb[:, :L], emb[:, L]
        else:
            seq_emb = self.item_emb(hist, capture.get("hist"))
        user_emb = self.encoder(seq_emb, lengths, train)
        out = {"user_emb": user_emb}
        if train:
            item = batch["target_item"]
            if target_emb is None:  # captured too: a fused step sees two lookups, refuses
                target_emb = self.item_emb(item, capture.get("hist"))
            features = safe_l2norm(torch.stack([user_emb, target_emb], dim=1))
            out["loss"] = (self.calculate_loss(user_emb, item, capture.get("ce"), seed)
                           + clrec_contra_loss(self.global_rows(features), self.temp))
        return out

    def jax_leaves(self):
        return ([(c, ("item_emb",) + p, t, tr) for c, p, t, tr in self.item_emb.jax_leaves()]
                + [(c, ("encoder",) + p, t, tr) for c, p, t, tr in self.encoder.jax_leaves()])
