"""GRU4Rec: the item embeddings through a two-layer GRU, read at each
history's last position and mapped back to the embedding width.

The JAX package's ``models/sequence/gru4rec.py``, its weights under the
same flax names (``jax_leaves``: ``gru/GRU_0/gru_l{0,1}/...``,
``gru/out``).  On the card the lookup is K1; the GRU's products and steps
are plain torch.  An empty history reads the carry after all L steps
(``GRU.last_carry``), as the JAX model does.
"""
from __future__ import annotations

import torch

from ...ops.sequence_enc import GRU4RecEncoder
from ..base import SequenceModelBase, register_model


@register_model("GRU4Rec")
class GRU4Rec(SequenceModelBase):
    fused_update_compatible = True

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        self.gru = GRU4RecEncoder(self.embedding_dim, self.embedding_dim, num_layers=2,
                                  generator=self.generator)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...], "ce": [...]} lists;
        ``seed``: the step's seed (see SequenceModelBase)."""
        capture = capture or {}
        seq_emb = self.item_emb(batch["hist_item_list"], capture.get("hist"))
        lengths = batch["hist_mask_list"].sum(dim=-1).to(torch.int64)
        user_emb = self.gru(seq_emb, lengths)
        out = {"user_emb": user_emb}
        if train:
            out["loss"] = self.calculate_loss(user_emb, batch["target_item"],
                                              capture.get("ce"), seed)
        return out

    def jax_leaves(self):
        return ([(c, ("item_emb",) + p, t, tr) for c, p, t, tr in self.item_emb.jax_leaves()]
                + [(c, ("gru",) + p, t, tr) for c, p, t, tr in self.gru.jax_leaves()])
