"""SASRec: item embeddings through the causal transformer encoder, read at
each history's last position."""
from __future__ import annotations

import torch

from ...ops.sequence_enc import TransformerEncoder
from ..base import SequenceModelBase, register_model


@register_model("SASRec")
class SASRec(SequenceModelBase):
    fused_update_compatible = True

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        cfg = self.config
        self.self_attention = TransformerEncoder(
            self.embedding_dim,
            n_layers=int(cfg.get("n_layers", 2)),
            n_heads=int(cfg.get("n_heads", 4)),
            inner_size=int(cfg.get("inner_size", 32)),
            hidden_dropout_prob=float(cfg.get("hidden_dropout_prob", 0.1)),
            attn_dropout_prob=float(cfg.get("attn_dropout_prob", 0.1)),
            hidden_act=cfg.get("hidden_act", "gelu"),
            layer_norm_eps=float(cfg.get("layer_norm_eps", 0.001)),
            generator=self.generator)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...], "ce": [...]} lists;
        ``seed``: the step's dropout seed (see SequenceModelBase)."""
        mask = batch["hist_mask_list"]
        lengths = mask.sum(dim=-1).to(torch.int64)
        capture = capture or {}
        seq_emb = self.item_emb(batch["hist_item_list"], capture.get("hist"))
        output = self.self_attention(seq_emb, mask, causal=True, train=train, seed=seed)
        # the last valid position, or 0 for an empty history; with a mask
        # that is not a prefix this may be a padded query, as in the reference
        user_emb = self.gather_indexes(output, (lengths - 1).clamp(min=0))
        out = {"user_emb": user_emb}
        if train:
            out["loss"] = self.calculate_loss(user_emb, batch["target_item"],
                                              capture.get("ce"), seed)
        return out

    def jax_leaves(self):
        return ([(c, ("item_emb",) + p, t, tr) for c, p, t, tr in self.item_emb.jax_leaves()]
                + [(c, ("self_attention",) + p, t, tr)
                   for c, p, t, tr in self.self_attention.jax_leaves()])
