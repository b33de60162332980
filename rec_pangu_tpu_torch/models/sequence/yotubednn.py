"""YotubeDNN: the user is the mean of the history's item embeddings over
all L positions (padded ones count as zero rows), the JAX package's
``models/sequence/yotubednn.py``.  Its only weight is the item table, so
the sequence fused step trains it with K3 alone (no dense Adam)."""
from __future__ import annotations

from ..base import SequenceModelBase, register_model


@register_model("YotubeDNN")
class YotubeDNN(SequenceModelBase):
    fused_update_compatible = True

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...], "ce": [...]} lists;
        ``seed``: the step's seed (see SequenceModelBase)."""
        capture = capture or {}
        seq_emb = self.item_emb(batch["hist_item_list"], capture.get("hist"))
        user_emb = (seq_emb * batch["hist_mask_list"][..., None]).mean(dim=1)
        out = {"user_emb": user_emb}
        if train:
            out["loss"] = self.calculate_loss(user_emb, batch["target_item"],
                                              capture.get("ce"), seed)
        return out

    def jax_leaves(self):
        return [(c, ("item_emb",) + p, t, tr) for c, p, t, tr in self.item_emb.jax_leaves()]
