"""NARM: an unpacked GRU over the history, its output at the last position
as the global encoding and an attention over every output as the local
one, both mapped to the embedding width.

The JAX package's ``models/sequence/narm.py``, its weights under the same
flax names (``gru/gru_l{i}/...``, ``a_1``, ``a_2``, ``v_t``, ``b``).  The
GRU runs over every position (no lengths); the read is at ``clip(lengths -
1, 0, L - 1)``, so an empty history reads position 0, unlike GRU4Rec; the
attention mask is ``item_seq > 0``.  Dropout on the embeddings and on the
concatenated encodings (``dropout_probs``) draws the fused encoder's hash
masks on streams of their own (``NARM_EMB_DROPOUT``, ``NARM_CT_DROPOUT``).
"""
from __future__ import annotations

import torch

from ...ops.kernels.fused_encoder import check_rate
from ...ops.sequence_enc import (GRU, NARM_CT_DROPOUT, NARM_EMB_DROPOUT, _dense,
                                 _linear_leaves, feature_dropout, step_seed)
from ..base import SequenceModelBase, register_model


@register_model("NARM")
class NARM(SequenceModelBase):
    fused_update_compatible = True

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        cfg = self.config
        n_layers = int(cfg.get("n_layers", 2))
        self.dropout_probs = [float(p) for p in cfg.get("dropout_probs", [0.1, 0.1])]
        for p in self.dropout_probs:
            check_rate(p)
        H = int(cfg.get("hidden_size", 32))
        gen = self.generator
        self.gru = GRU(self.embedding_dim, H, n_layers, gen)
        self.a_1 = _dense(H, H, gen, bias=False)
        self.a_2 = _dense(H, H, gen, bias=False)
        self.v_t = _dense(H, 1, gen, bias=False)
        self.b = _dense(2 * H, self.embedding_dim, gen, bias=False)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...], "ce": [...]} lists;
        ``seed``: the step's seed (see SequenceModelBase)."""
        item_seq = batch["hist_item_list"]
        lengths = batch["hist_mask_list"].sum(dim=-1).to(torch.int64)
        capture = capture or {}
        if train:
            seed = step_seed(seed)
        seq_emb = self.item_emb(item_seq, capture.get("hist"))
        if train:
            seq_emb = feature_dropout(seq_emb, self.dropout_probs[0], seed, NARM_EMB_DROPOUT)
        gru_out = self.gru(seq_emb)
        ht = self.gather_indexes(gru_out, (lengths - 1).clamp(0, gru_out.shape[1] - 1))
        mask = (item_seq > 0)[..., None].to(gru_out.dtype)
        alpha = self.v_t(mask * torch.sigmoid(self.a_1(gru_out) + self.a_2(ht)[:, None, :]))
        c_t = torch.cat([(alpha * gru_out).sum(dim=1), ht], dim=1)
        if train:
            c_t = feature_dropout(c_t, self.dropout_probs[1], seed, NARM_CT_DROPOUT)
        user_emb = self.b(c_t)
        out = {"user_emb": user_emb}
        if train:
            out["loss"] = self.calculate_loss(user_emb, batch["target_item"],
                                              capture.get("ce"), seed)
        return out

    def jax_leaves(self):
        return ([(c, ("item_emb",) + p, t, tr) for c, p, t, tr in self.item_emb.jax_leaves()]
                + [(c, ("gru",) + p, t, tr) for c, p, t, tr in self.gru.jax_leaves()]
                + _linear_leaves(self, ("a_1", "a_2", "v_t", "b")))
