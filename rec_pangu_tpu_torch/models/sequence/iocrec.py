"""IOCRec: a local causal transformer and a global query-bank attention over
the same item embeddings, disentangled into K intentions [B, K, L, D], with
an InfoNCE loss over two augmented views beside the K-max softmax CE.

The JAX package's ``models/sequence/iocrec.py``, with its weights under the
same flax names (``jax_leaves``).  One lookup of the ``[3B, L]`` ids
``aug_all = [hist; aug1; aug2]`` serves both encoders in training (the
history and its two views encoded as one batch); in eval the histories
alone.  On the card the lookup is K1, the local encoder K4f (K4b backward),
the global encoder K6f (K6b backward) and the full K-max CE K5f (K5b
backward); on the CPU their plain versions.

The disentangled tensor is kept factored (``DisentangleFactors``):
``layer_norm_5(s * e)`` of a positive per-(b, k, l) scalar ``s`` times the
encoder row ``e`` is ``alpha * (e - mean(e)) * gamma + beta``, so only the
scalars ``alpha`` carry the K axis; the dense tensor is built for the
contrastive views only.

Dropout: the local encoder's three sites (its kernels' hash), the input
dropout and the global encoder's output each draw the fused encoder's hash
masks from the step's seed on their own stream
(``global_attn.DROPOUT_LAYER`` with ``INPUT_SITE`` and ``OUTPUT_SITE``), so
the card and the CPU drop the same elements.

Under a data-parallel mesh each rank's block stacks its rows of the three
views, [hist_b; aug1_b; aug2_b]: the encoders then run view by view, each
with the view's rows of the global stack as its dropout rows
(``ops/dropout.view_seeds``, the kernels' ``first``), and the InfoNCE reads
the whole batch's views (``global_rows``).  Under a ``model`` axis the K-max
CE runs over the rank's rows of the item table
(``softmax_ce.sharded_multimax_softmax_ce``).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ...ops.initializers import kaiming_normal_
from ...ops.kernels.fused_encoder import check_rate
from ...ops.kernels.global_attn import DROPOUT_LAYER, INPUT_SITE, global_attn
from ...ops.sequence_enc import (TransformerEncoder, _dense, feature_dropout, step_seed,
                                 view_seeds)
from ...ops.softmax_ce import (fused_multimax_softmax_ce_captured,
                               fused_multimax_softmax_ce_padded, naive_multimax_softmax_ce,
                               sharded_multimax_softmax_ce, streamed_ce_applies)
from ..base import SequenceModelBase, register_model
from .augment import augment_sequences


def info_nce_loss(v1: torch.Tensor, v2: torch.Tensor, temperature: float) -> torch.Tensor:
    """Pair-wise InfoNCE over flattened views (dot similarity): row i of each
    view against the other view's row i, the rest of both views negatives."""
    B = v1.shape[0]
    v1 = v1.reshape(B, -1)
    v2 = v2.reshape(B, -1)
    sim11 = torch.matmul(v1, v1.t())
    sim22 = torch.matmul(v2, v2.t())
    sim12 = torch.matmul(v1, v2.t())
    inf_diag = torch.eye(B, device=v1.device) * -1e9
    sim11 = sim11 + inf_diag
    sim22 = sim22 + inf_diag
    logits = torch.cat([torch.cat([sim12, sim11], dim=-1),
                        torch.cat([sim22, sim12.t()], dim=-1)], dim=0) / temperature
    labels = torch.arange(2 * B, device=v1.device)
    return -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None]).mean()


class _FlaxDense(nn.Module):
    """A flax ``Dense``'s params in its own layout, kernel ``[in, out]`` and
    bias ``[out]``, which the global-attention kernels read as they are."""

    def __init__(self, dim: int, generator: torch.Generator):
        super().__init__()
        layer = _dense(dim, dim, generator)
        self.kernel = nn.Parameter(layer.weight.detach().t().contiguous())
        self.bias = layer.bias


class GlobalSeqEncoder(nn.Module):
    """``drop(softmax(Q_s K(x)^T) V(x))``: the global-attention kernels
    (``ops/kernels/global_attn.py``) on the card."""

    def __init__(self, max_len: int, dim: int, dropout: float, generator: torch.Generator):
        super().__init__()
        check_rate(dropout)
        self.dropout = float(dropout)
        self.Q_s = nn.Parameter(torch.empty(max_len, dim))
        kaiming_normal_(self.Q_s, generator)
        self.K_linear = _FlaxDense(dim, generator)
        self.V_linear = _FlaxDense(dim, generator)

    def params(self) -> Tuple[torch.Tensor, ...]:
        """(wk, bk, wv, bv, q_s), the kernels' arguments."""
        return (self.K_linear.kernel, self.K_linear.bias, self.V_linear.kernel,
                self.V_linear.bias, self.Q_s)

    def forward(self, x: torch.Tensor, train: bool = False, seed: int = 0) -> torch.Tensor:
        """Sample i draws the dropout mask of row ``seed.first_row + i`` for a
        ``RowSeed``."""
        return global_attn(x, self.params(), seed, self.dropout, train,
                           getattr(seed, "first_row", 0))

    def jax_leaves(self):
        return [("params", ("Q_s",), self.Q_s, False)] + [
            ("params", (name, leaf), getattr(layer, leaf), False)
            for name, layer in (("K_linear", self.K_linear), ("V_linear", self.V_linear))
            for leaf in ("kernel", "bias")]


class DisentangleFactors(NamedTuple):
    """The factored intention tensor ``y[b, k, l] = alpha_l[b, k, l] c_l[b, l]
    + alpha_g[b, k, l] c_g[b, l] + 2 beta``: alphas [B, K, L], c [B, L, D],
    beta [D]."""

    alpha_l: torch.Tensor
    c_l: torch.Tensor
    alpha_g: torch.Tensor
    c_g: torch.Tensor
    beta: torch.Tensor

    def dense(self) -> torch.Tensor:
        """The [B, K, L, D] tensor."""
        y = torch.einsum("bkl,bld->bkld", self.alpha_l, self.c_l)
        y = y + torch.einsum("bkl,bld->bkld", self.alpha_g, self.c_g)
        return y + 2.0 * self.beta

    def slice_rows(self, a: int, b: int) -> "DisentangleFactors":
        return DisentangleFactors(self.alpha_l[a:b], self.c_l[a:b], self.alpha_g[a:b],
                                  self.c_g[a:b], self.beta)

    def gather_user_emb(self, idx: torch.Tensor) -> torch.Tensor:
        """y at position ``idx`` [B] of each row -> [B, K, D]."""
        rows = torch.arange(idx.shape[0], device=idx.device)
        al = self.alpha_l[rows, :, idx]
        ag = self.alpha_g[rows, :, idx]
        wl = self.c_l[rows, idx]
        wg = self.c_g[rows, idx]
        return al[..., None] * wl[:, None, :] + ag[..., None] * wg[:, None, :] + 2.0 * self.beta


class DisentangleEncoder(nn.Module):
    """Item-to-intention scores times an attention over positions, applied
    to each encoder's rows through ``layer_norm_5`` in factored form.  The
    five LayerNorms take torch's default eps 1e-5, as the reference's do."""

    def __init__(self, k_intention: int, max_len: int, dim: int, generator: torch.Generator,
                 ln_eps: float = 1e-5):
        super().__init__()
        self.ln_eps = float(ln_eps)
        self.intentions = nn.Parameter(torch.empty(k_intention, dim))
        self.pos_fai = nn.Parameter(torch.empty(max_len, dim))
        self.rou = nn.Parameter(torch.empty(dim))
        kaiming_normal_(self.intentions, generator)
        kaiming_normal_(self.pos_fai, generator)
        with torch.no_grad():
            self.rou.normal_(generator=generator)
        self.W = _dense(dim, dim, generator)
        for i in range(1, 6):
            setattr(self, f"layer_norm_{i}", nn.LayerNorm(dim, eps=self.ln_eps))

    def factors(self, e: torch.Tensor, seq_len: torch.Tensor):
        """(alpha [B, K, L], c [B, L, D]) of one encoder's rows e [B, L, D]."""
        B, L, D = e.shape
        logits = torch.einsum("bld,kd->blk", self.layer_norm_1(e),
                              self.layer_norm_2(self.intentions))
        i2i = torch.softmax(logits / math.sqrt(D), dim=-1)
        idx = (seq_len - 1).clamp(0, L - 1)
        q_row = e[torch.arange(B, device=e.device), idx] + self.pos_fai[idx] + self.rou
        query = self.layer_norm_3(q_row)
        key_hat = self.layer_norm_4(e + self.pos_fai[:L])
        key = key_hat + torch.relu(self.W(key_hat))
        attn = torch.softmax(torch.einsum("bd,bmd->bm", query, key) / math.sqrt(D), dim=-1)
        s = (i2i * attn[..., None]).transpose(1, 2)  # [B, K, L]
        mu = e.mean(dim=-1, keepdim=True)
        var = (e - mu).square().mean(dim=-1)
        alpha = s * torch.rsqrt(s.square() * var[:, None, :] + self.ln_eps)
        return alpha, (e - mu) * self.layer_norm_5.weight

    def forward(self, local: torch.Tensor, glob: torch.Tensor,
                seq_len: torch.Tensor) -> DisentangleFactors:
        al, cl = self.factors(local, seq_len)
        ag, cg = self.factors(glob, seq_len)
        return DisentangleFactors(al, cl, ag, cg, self.layer_norm_5.bias)

    def jax_leaves(self):
        leaves = [("params", ("intentions",), self.intentions, False),
                  ("params", ("pos_fai",), self.pos_fai, False),
                  ("params", ("rou",), self.rou, False),
                  ("params", ("W", "kernel"), self.W.weight, True),
                  ("params", ("W", "bias"), self.W.bias, False)]
        for i in range(1, 6):
            norm = getattr(self, f"layer_norm_{i}")
            leaves += [("params", (f"layer_norm_{i}", "scale"), norm.weight, False),
                       ("params", (f"layer_norm_{i}", "bias"), norm.bias, False)]
        return leaves


@register_model("IOCRec")
class IOCRec(SequenceModelBase):
    # in training the item table is read by the one [3B, L] lookup and the
    # K-max CE only: the sequence fused step captures both
    fused_update_compatible = True
    host_aug = True               # the trainer builds batch["aug_all"] on the host
    fused_lookup_key = "aug_all"  # the ids of the fused step's captured rows

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        cfg = self.config
        D, L, gen = self.embedding_dim, self.max_length, self.generator
        self.tao = float(cfg.get("tao", 2))
        self.beta_a = float(cfg.get("beta_a", 3.0))
        self.beta_b = float(cfg.get("beta_b", 3.0))
        self.lamda = float(cfg.get("lamda", 0.1))
        self.k_intention = int(cfg.get("K", 4))
        eps = float(cfg.get("layer_norm_eps", 1e-12))
        self.hidden_dropout = float(cfg.get("hidden_dropout", 0.5))
        check_rate(self.hidden_dropout)
        self.position_embedding = nn.Parameter(torch.empty(L, D))
        with torch.no_grad():  # flax's fan-in normal on an [L, D] param: std sqrt(2 / L)
            self.position_embedding.normal_(0.0, math.sqrt(2.0 / L), generator=gen)
        self.input_layer_norm = nn.LayerNorm(D, eps=eps)
        self.local_encoder = TransformerEncoder(
            D, n_layers=int(cfg.get("num_blocks", 3)), n_heads=int(cfg.get("num_heads", 2)),
            inner_size=int(cfg.get("ffn_hidden", 128)), hidden_dropout_prob=self.hidden_dropout,
            attn_dropout_prob=float(cfg.get("attn_dropout", 0.5)), hidden_act="relu",
            layer_norm_eps=eps, generator=gen)
        self.global_seq_encoder = GlobalSeqEncoder(L, D, self.hidden_dropout, gen)
        self.disentangle_encoder = DisentangleEncoder(self.k_intention, L, D, gen)
        # the last id is the mask token: a real item, as in the reference
        self.mask_token = int(enc_dict[cfg.get("item_col", "item_id")]["vocab_size"]) - 1

    def _local_from_emb(self, emb: torch.Tensor, item_seq: torch.Tensor, train: bool,
                        seed: int) -> torch.Tensor:
        L = emb.shape[1]
        x = self.input_layer_norm(emb + self.position_embedding[:L])
        if train:
            x = feature_dropout(x, self.hidden_dropout, seed, (DROPOUT_LAYER, INPUT_SITE))
        return self.local_encoder(x, item_seq != 0, causal=True, train=train, seed=seed)

    def _intention_factors(self, item_seq: torch.Tensor, seq_len: torch.Tensor, train: bool,
                           seed: int, capture: Optional[List[torch.Tensor]] = None
                           ) -> DisentangleFactors:
        # one lookup serves both encoders
        emb = self.item_emb(item_seq, capture)
        seeds = view_seeds(seed, 3) if train else None
        if seeds is None:
            local = self._local_from_emb(emb, item_seq, train, seed)
            glob = self.global_seq_encoder(emb, train, seed)
        else:  # a data-parallel block of the three views: each view at its global rows
            parts = [(self._local_from_emb(e, s, train, v), self.global_seq_encoder(e, train, v))
                     for e, s, v in zip(emb.chunk(3), item_seq.chunk(3), seeds)]
            local = torch.cat([p[0] for p in parts])
            glob = torch.cat([p[1] for p in parts])
        return self.disentangle_encoder(local, glob, seq_len)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...], "ce": [...]} lists;
        ``seed``: the step's dropout seed (see SequenceModelBase).  A training
        batch without ``aug_all`` gets its two views from a generator seeded
        by ``seed``."""
        item_seq = batch["hist_item_list"]
        seq_len = batch["hist_mask_list"].sum(dim=-1).to(torch.int64)
        B, L = item_seq.shape
        capture = capture or {}
        if train:
            seed = step_seed(seed)
            all_seq = batch.get("aug_all")
            if all_seq is None:
                gen = torch.Generator(device=item_seq.device).manual_seed(seed + 2)
                views = [augment_sequences(gen, item_seq, self.beta_a, self.beta_b,
                                           self.mask_token) for _ in range(2)]
                all_seq = torch.cat([item_seq] + views, dim=0)
            factors3 = self._intention_factors(all_seq, seq_len.repeat(3), True, seed,
                                               capture.get("hist"))
            factors = factors3.slice_rows(0, B)
        else:
            factors = self._intention_factors(item_seq, seq_len, False, 0, capture.get("hist"))
        user_emb = factors.gather_user_emb((seq_len - 1).clamp(0, L - 1))
        out = {"user_emb": user_emb}
        if train:
            rec = self._rec_loss(user_emb, batch["target_item"], capture.get("ce"), seed)
            out["loss"] = rec + self.lamda * self._cl_loss(factors3, B)
        return out

    def _rec_loss(self, user_emb: torch.Tensor, pos_item: torch.Tensor,
                  capture: Optional[List[torch.Tensor]], seed: int) -> torch.Tensor:
        """The JAX branches, in its order: the sampled K-max CE for
        ``loss_type`` "sampled"; the captured K-max CE in the fused step; the
        streamed K-max CE over the raw table from 65,536 items (or with
        ``REC_PANGU_TPU_FUSED_CE=1``); the naive [B, K, V] form below."""
        table, vocab = self.item_emb.table, self.item_emb.vocab_size
        if self.config.get("loss_type", "full") == "sampled":
            gen = torch.Generator(device=user_emb.device).manual_seed(seed + 1)
            return self.calculate_multimax_sampled_loss(
                user_emb, pos_item, int(self.config.get("num_negatives", 1024)), gen)
        if capture is not None:
            return fused_multimax_softmax_ce_captured(user_emb, table.detach(), pos_item,
                                                      capture, vocab)
        if self.item_emb.row_shard is not None:
            return sharded_multimax_softmax_ce(user_emb, table, pos_item,
                                               self.item_emb.row_shard[0], vocab,
                                               self.item_emb.mesh_state.model_group)
        if streamed_ce_applies(vocab):
            return fused_multimax_softmax_ce_padded(user_emb, table, pos_item, vocab)
        return naive_multimax_softmax_ce(user_emb, self.output_items(), pos_item)

    def _cl_loss(self, factors3: DisentangleFactors, B: int) -> torch.Tensor:
        # the contrastive views are the one consumer of the dense tensor
        # (the whole batch's views under a data-parallel mesh)
        aug = factors3.slice_rows(B, 3 * B).dense()
        v1, v2 = self.global_rows(aug[:B]), self.global_rows(aug[B:])
        d1 = v1.reshape(v1.shape[0] * self.k_intention, -1)
        d2 = v2.reshape(v2.shape[0] * self.k_intention, -1)
        return info_nce_loss(d1, d2, self.tao)

    def jax_leaves(self):
        def under(name, module):
            return [(c, (name,) + p, t, tr) for c, p, t, tr in module.jax_leaves()]

        return (under("item_emb", self.item_emb)
                + [("params", ("position_embedding",), self.position_embedding, False),
                   ("params", ("input_layer_norm", "scale"), self.input_layer_norm.weight, False),
                   ("params", ("input_layer_norm", "bias"), self.input_layer_norm.bias, False)]
                + under("local_encoder", self.local_encoder)
                + under("global_seq_encoder", self.global_seq_encoder)
                + under("disentangle_encoder", self.disentangle_encoder))
