"""CMI: a global bank of K interests, one soft assignment of the history to
them, a GRU's personal embedding added to each, and an InfoNCE-style loss
of the best interest against the target and one negative a history, plus a
contrastive loss between the interests of paired histories.

The JAX package's ``models/sequence/cmi.py``, its weights under the same
flax names (``interest_embedding`` [K, D], ``gru/gru_l{i}/...``, ``mlp``).
Training is projected, as in the reference: the trainer puts every row of
the item table and of the interest bank back on the unit sphere before the
first step and after each (``renorm_param_paths``), and reads divide by a
norm without gradient (``stopgrad_norm``), so a read row's gradient is
g / ||row||.  In training the history, the target and the host-drawn
negative (``neg_items``, ``host_negatives``) are read by one lookup of
``lookup_all`` = [hist | target | neg] [B, L + 2], the fused step's ids
(a training batch without it raises: the JAX package would draw the
negatives on the device from its dropout key); the loss has no
full-softmax term, so the fused step passes K3 no dense
stream.  Serving and eval read the history rows with the same lookup and
normalize them (the norm is by row, so this is the gather from the
normalized table the JAX package makes).  The orthogonality and uniformity
terms stay out of the loss, as in the JAX package and the reference.  On
the card the lookup is K1; the GRU is plain torch, a loop over the L
steps, as GRU4Rec's.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.initializers import flax_fan_in_normal_
from ...ops.kernels.fused_encoder import check_rate
from ...ops.numerics import safe_l2norm
from ...ops.sequence_enc import (CMI_EMB_DROPOUT, GRU, _dense, _linear_leaves,
                                 feature_dropout, step_seed)
from ..base import SequenceModelBase, register_model


def stopgrad_norm(w: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rows of ``w`` divided by their norm (at least ``eps``) held out of
    autograd."""
    return w / torch.linalg.vector_norm(w.detach(), dim=-1, keepdim=True).clamp_min(eps)


@register_model("CMI")
class CMI(SequenceModelBase):
    fused_update_compatible = True
    fused_lookup_key = "lookup_all"                 # [hist | target | neg]: the fused ids
    lookup_extra = ("target_item", "neg_items")     # what the trainer appends to the histories
    host_negatives = True                           # the trainer draws neg_items
    fused_uses_ce = False
    renorm_param_paths = (("item_emb", "table"), ("interest_embedding",))

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        cfg = self.config
        D, gen = self.embedding_dim, self.generator
        self.dropout_prob = float(cfg.get("dropout_prob", 0))
        check_rate(self.dropout_prob)
        self.temp = float(cfg.get("temp", 0.1))
        self.w_clloss = float(cfg.get("w_clloss", 0.05))
        self.n_interest = int(cfg.get("K", 8))
        self.temperature = 0.1
        self.interest_embedding = nn.Parameter(torch.empty(self.n_interest, D))
        flax_fan_in_normal_(self.interest_embedding, gen)
        self.gru = GRU(D, D, int(cfg.get("num_layers", 2)), gen)
        self.mlp = _dense(D, D, gen)

    def output_items(self) -> torch.Tensor:
        return stopgrad_norm(self.item_emb.all_items())

    def output_item_block(self):
        block, first = self.item_emb.local_items()
        return stopgrad_norm(block), first

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...]} list; ``seed``: the
        step's seed (see SequenceModelBase)."""
        capture = capture or {}
        item_seq = batch["hist_item_list"]
        lengths = batch["hist_mask_list"].sum(dim=-1).to(torch.int64)
        B, L = item_seq.shape
        bank = stopgrad_norm(self.interest_embedding)
        if train:
            if "lookup_all" not in batch:
                raise ValueError("CMI's training forward reads lookup_all = [hist | target | "
                                 "neg] [B, L + 2], which SequenceTrainer builds on the host")
            emb = stopgrad_norm(self.item_emb(batch["lookup_all"], capture.get("hist")))
            seq_emb, pos_emb, neg_emb = emb[:, :L], emb[:, L], emb[:, L + 1]
        else:
            seq_emb = stopgrad_norm(self.item_emb(item_seq))
        if train and self.dropout_prob > 0:
            seq_emb = feature_dropout(seq_emb, self.dropout_prob,
                                      step_seed(seed),
                                      CMI_EMB_DROPOUT)

        # one soft assignment to the bank
        probs = torch.softmax(torch.matmul(seq_emb, bank.T) / self.temp, dim=-1)
        probs = probs * (item_seq > 0)[..., None]                            # [B, L, K]
        interests = safe_l2norm(torch.matmul(probs.transpose(1, 2), seq_emb))
        assigned = probs.sum(dim=1)[..., None] > 0
        interests = torch.where(assigned, interests, bank[None])              # [B, K, D]

        # the GRU's personal embedding
        gru_out = torch.relu(self.mlp(self.gru(seq_emb)))
        full_psnl = safe_l2norm(self.gather_indexes(gru_out, (lengths - 1).clamp_min(0)))
        interests = safe_l2norm(interests + full_psnl[:, None, :])
        out = {"user_emb": interests}
        if train:
            out["global_user_emb"] = full_psnl
            out["loss"] = self.cmi_loss(interests, pos_emb, neg_emb)
        return out

    def cmi_loss(self, interests: torch.Tensor, pos_emb: torch.Tensor,
                 neg_emb: torch.Tensor) -> torch.Tensor:
        """The best interest's score of the target against every history's
        negative (the max over the interests), an InfoNCE at ``temp``; plus
        ``w_clloss`` times ``multi_interest_clloss`` when B is even.  Under a
        data-parallel mesh both read the whole batch's negatives and
        interests (``global_rows``)."""
        pos_scores = (interests * pos_emb[:, None, :]).sum(dim=-1)              # [B, K]
        neg_scores = torch.matmul(interests, self.global_rows(neg_emb).T)       # [B, K, B]
        scores = torch.cat([pos_scores[..., None], neg_scores], dim=-1).amax(dim=1)
        loss = -torch.log_softmax(scores / self.temp, dim=-1)[:, 0].mean()
        every = self.global_rows(interests)
        if every.shape[0] % 2 == 0:
            loss = loss + self.w_clloss * self.multi_interest_clloss(every)
        return loss

    def multi_interest_clloss(self, interests: torch.Tensor) -> torch.Tensor:
        """Histories 2i and 2i + 1 as two views: the InfoNCE of their
        interests both ways at ``temperature``."""
        B, K, D = interests.shape
        pairs = interests.reshape(B // 2, 2, K, D)
        a = safe_l2norm(pairs[:, 0].reshape(-1, D))
        b = safe_l2norm(pairs[:, 1].reshape(-1, D))
        sim = torch.matmul(a, b.T) / self.temperature
        return (-torch.log_softmax(sim, dim=-1).diagonal().mean()
                - torch.log_softmax(sim.T, dim=-1).diagonal().mean())

    def jax_leaves(self):
        return ([(c, ("item_emb",) + p, t, tr) for c, p, t, tr in self.item_emb.jax_leaves()]
                + [("params", ("interest_embedding",), self.interest_embedding, False)]
                + [(c, ("gru",) + p, t, tr) for c, p, t, tr in self.gru.jax_leaves()]
                + _linear_leaves(self, ("mlp",)))
