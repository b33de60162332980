"""Re4: K interest proposals over the history, and in training the
re-attend, re-contrast and re-construct losses beside the full-softmax CE
of the best interest for the target item.

The JAX package's ``models/sequence/re4.py``, its weights under the same
flax names (``W1``, ``W1_2``, ``W2``, ``W3``, ``W3_2``, ``W5`` in flax's
layout; Dense ``fc1`` and ``fc_cons``).  It keeps the JAX package's
documented deviation from the reference: the re-contrast gate is one over
the true history length, not over the padding count.  Masked scores are
-1e9, so their exponentials (of up to 1/t_cont = 50 times a cosine) are
exact zeros.  The re-contrast loss is computed in log space (a log-sum-exp
of the negatives minus the positive's score), the same function as the JAX
package's ratio of exponentials, whose float32 gradient underflows at
these magnitudes; the tests hold its gradient against the JAX package's in
float64.  The target read feeds only ``best_interest``'s argmax and is
made without autograd (``comirec.target_rows``), outside the fused step's
capture; on the card both reads are K1.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.initializers import kaiming_normal_
from ...ops.numerics import safe_l2norm
from ...ops.sequence_enc import _dense, _linear_leaves
from ..base import SequenceModelBase, register_model
from .comirec import best_interest, target_rows

_RAW = ("W1", "W1_2", "W2", "W3", "W3_2", "W5")


@register_model("Re4")
class Re4(SequenceModelBase):
    fused_update_compatible = True

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        cfg = self.config
        D, L, gen = self.embedding_dim, self.max_length, self.generator
        self.K = int(cfg.get("K", 4))
        self.att_thre = float(cfg.get("att_thre", -1))
        self.t_cont = float(cfg.get("t_cont", 0.02))
        self.att_lambda = float(cfg.get("att_lambda", 0.01))
        self.ct_lambda = float(cfg.get("ct_lambda", 0.1))
        self.cs_lambda = float(cfg.get("cs_lambda", 0.1))
        shapes = {"W1": (256, D), "W1_2": (self.K, 256), "W2": (D, D), "W3": (D, D),
                  "W3_2": (L, D), "W5": (D, D)}
        for name in _RAW:
            w = nn.Parameter(torch.empty(shapes[name]))
            kaiming_normal_(w, gen)
            setattr(self, name, w)
        self.fc1 = _dense(D, D, gen)
        self.fc_cons = _dense(D, D * L, gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...], "ce": [...]} lists;
        ``seed``: the step's seed (see SequenceModelBase)."""
        capture = capture or {}
        item_seq = batch["hist_item_list"]
        mask = batch["hist_mask_list"]
        pad = mask == 0                                                     # [B, L]
        B, L = item_seq.shape
        K, D = self.K, self.embedding_dim
        seq_emb = self.item_emb(item_seq, capture.get("hist"))             # [B, L, D]

        # interest proposals
        logits = torch.matmul(torch.matmul(self.W1_2, self.W1), seq_emb.transpose(1, 2))
        logits = torch.where(pad[:, None, :], -1e9, logits)                # [B, K, L]
        proposals_weight = torch.softmax(logits, dim=2)
        user_interests = torch.matmul(proposals_weight, torch.matmul(seq_emb, self.W2))
        if not train:
            return {"user_emb": torch.tanh(self.fc1(user_interests))}

        target_item = batch["target_item"]
        item_e = target_rows(self.item_emb, target_item)

        # re-attend
        product = torch.matmul(user_interests, seq_emb.transpose(1, 2))
        re_att = torch.softmax(torch.where(pad[:, None, :], -1e9, product), dim=2)
        att_pred = torch.log_softmax(logits, dim=-1)
        loss_attend = -(re_att * att_pred).sum() / re_att.sum()

        # re-contrast
        ni = safe_l2norm(user_interests)
        ne = safe_l2norm(seq_emb)
        cos_sim = torch.matmul(ni, ne.transpose(1, 2))                      # [B, K, L]
        if self.att_thre == -1:
            gate = (1.0 / mask.sum(dim=1).clamp_min(1.0))[:, None, None]
        else:
            gate = torch.full((B, 1, 1), self.att_thre, device=mask.device)
        positive = proposals_weight > gate
        mask_cos = torch.where(pad[:, None, :], -1e9, cos_sim)
        eye = torch.eye(K, dtype=torch.bool, device=ni.device)
        in2in = torch.where(eye[None], -1e9, torch.matmul(ni, ni.transpose(1, 2)))
        # each history against the previous history's items (the batch's
        # rows rolled by one: across the data ranks' blocks under a mesh)
        prev = self.block_rows(torch.roll(self.global_rows(ne), 1, dims=0), B)
        prev_pad = self.block_rows(torch.roll(self.global_rows(item_seq), 1, dims=0), B) == 0
        in2i = torch.matmul(ni, prev.transpose(1, 2))
        in2i = torch.where(prev_pad[:, None, :], -1e9, in2i)
        # -log(exp(pos / t) / sum(exp(neg / t))) as log-sum-exp minus pos / t:
        # the same function as the JAX package's ratio of exponentials, whose
        # float32 gradient drops the negatives' terms once the sum nears e^50
        # (the divisor's gradient, ratio / sum / sum, underflows to 0)
        log_neg = torch.logsumexp(torch.cat([mask_cos, in2in, in2i], dim=2) / self.t_cont, dim=2)
        contrast = log_neg[..., None] - mask_cos / self.t_cont
        loss_contrastive = torch.where(positive & ~pad[:, None, :], contrast, 0.0).mean()

        # re-construct: recons_weight[b, i, j] = W3_2[i] . tanh(W3 @ recons[b, j])
        recons = self.fc_cons(user_interests).reshape(B * K, L, D)
        rw = torch.matmul(self.W3_2, torch.tanh(torch.matmul(recons, self.W3.T)).transpose(1, 2))
        rw = torch.where((item_seq == 0)[:, None, None, :], -1e9, rw.reshape(B, K, L, L))
        rw = torch.softmax(rw.reshape(B * K, L, L), dim=-1)
        recons_item = torch.matmul(rw, torch.matmul(recons, self.W5)).reshape(B, K, L, D)
        sq = (recons_item - seq_emb[:, None]) ** 2
        sq = torch.where((~positive | pad[:, None, :])[..., None], 0.0, sq)
        loss_construct = sq.mean()

        user_interests = torch.tanh(self.fc1(user_interests))
        best = best_interest(user_interests, item_e)
        loss = self.calculate_loss(best, target_item, capture.get("ce"), seed)
        loss = (loss + self.att_lambda * loss_attend + self.ct_lambda * loss_contrastive
                + self.cs_lambda * loss_construct)
        return {"user_emb": user_interests, "loss": loss}

    def jax_leaves(self):
        return ([(c, ("item_emb",) + p, t, tr) for c, p, t, tr in self.item_emb.jax_leaves()]
                + [("params", (n,), getattr(self, n), False) for n in _RAW]
                + _linear_leaves(self, ("fc1", "fc_cons")))
