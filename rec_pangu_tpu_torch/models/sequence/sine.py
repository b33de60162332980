"""SINE: a bank of ``prototype_size`` concepts, the history's top
``interest_size`` of them, each position assigned to them, an attention per
interest, and the interests aggregated into one user embedding [B, D]
through the full-softmax CE.

The JAX package's ``models/sequence/sine.py``, its weights under the same
flax names (``w1``-``w4``, ``C``, ``w_k_1``, ``w_k_2`` in flax's layout;
``ln2``, ``ln4`` LayerNorms of eps ``layer_norm_eps``, 1e-4 by default).
``torch.topk`` gives ``jax.lax.top_k``'s concepts in the same descending
order.  The only table reads are the history lookup and the CE, both
captured by the fused step; on the card the lookup is K1.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.initializers import kaiming_normal_
from ...ops.numerics import safe_l2norm
from ..base import SequenceModelBase, register_model


@register_model("SINE")
class SINE(SequenceModelBase):
    fused_update_compatible = True

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        cfg = self.config
        D, gen = self.embedding_dim, self.generator
        self.num_concepts = int(cfg.get("prototype_size", 500))
        self.k = int(cfg.get("interest_size", 4))
        self.tau = float(cfg.get("tau_ratio", 0.1))
        eps = float(cfg.get("layer_norm_eps", 1e-4))
        shapes = {"w1": (D, D), "w2": (D,), "w3": (D, D), "w4": (D,),
                  "C": (self.num_concepts, D), "w_k_1": (self.k, D, D), "w_k_2": (self.k, D)}
        for name, shape in shapes.items():
            w = nn.Parameter(torch.empty(shape))
            if w.dim() == 1:  # the 1-D weights keep their constructor's 0.01 normal
                with torch.no_grad():
                    w.normal_(0.0, 0.01, generator=gen)
            else:
                kaiming_normal_(w, gen)
            setattr(self, name, w)
        self.ln2 = nn.LayerNorm(D, eps=eps)
        self.ln4 = nn.LayerNorm(D, eps=eps)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...], "ce": [...]} lists;
        ``seed``: the step's seed (see SequenceModelBase)."""
        capture = capture or {}
        x_u = self.item_emb(batch["hist_item_list"], capture.get("hist"))        # [B, N, D]

        # concept activation
        a = torch.softmax(torch.matmul(torch.tanh(torch.matmul(x_u, self.w1)), self.w2), dim=1)
        z_u = torch.matmul(a[:, None, :], x_u)[:, 0]                             # [B, D]
        s_u = torch.matmul(z_u, self.C.T)                                        # [B, L]
        s_u_top, idx = torch.topk(s_u, self.k, dim=1)
        C_u = self.C[idx] * torch.sigmoid(s_u_top)[..., None]                    # [B, k, D]

        # intention assignment
        w3_x_u_norm = safe_l2norm(torch.matmul(x_u, self.w3))
        P_k_t_b = torch.softmax(torch.matmul(w3_x_u_norm, self.ln2(C_u).transpose(1, 2)),
                                dim=2)                                           # [B, N, k]

        # attention weighting
        a_k = torch.einsum("bnd,kde->bkne", x_u, self.w_k_1)
        P_t_k = torch.softmax(torch.einsum("bkne,ke->bkn", torch.tanh(a_k), self.w_k_2), dim=2)

        # interest embeddings
        mul_p = P_k_t_b.transpose(1, 2) * P_t_k                                  # [B, k, N]
        delta_k = safe_l2norm(torch.matmul(mul_p, x_u))                          # [B, k, D]

        # prototype sequence
        x_u_bar = torch.matmul(P_k_t_b, C_u)                                     # [B, N, D]
        C_apt = torch.softmax(torch.matmul(torch.tanh(torch.matmul(x_u_bar, self.w3)), self.w4),
                              dim=1)
        C_apt = self.ln4(torch.matmul(C_apt[:, None, :], x_u_bar)[:, 0])        # [B, D]

        # aggregation
        e_k = torch.matmul(delta_k, C_apt[:, :, None])[..., 0] / self.tau
        user_emb = torch.matmul(torch.softmax(e_k, dim=1)[:, None, :], delta_k)[:, 0]
        out = {"user_emb": user_emb}
        if train:
            out["loss"] = self.calculate_loss(user_emb, batch["target_item"],
                                              capture.get("ce"), seed)
        return out

    def jax_leaves(self):
        leaves = [(c, ("item_emb",) + p, t, tr) for c, p, t, tr in self.item_emb.jax_leaves()]
        leaves += [("params", (n,), getattr(self, n), False)
                   for n in ("w1", "w2", "w3", "w4", "C", "w_k_1", "w_k_2")]
        for name in ("ln2", "ln4"):
            norm = getattr(self, name)
            leaves += [("params", (name, "scale"), norm.weight, False),
                       ("params", (name, "bias"), norm.bias, False)]
        return leaves
