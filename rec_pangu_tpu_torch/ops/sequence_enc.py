"""Sequence encoders: the post-LN transformer stack and BERT4Rec's
bidirectional encoder built on it; the GRU, GRU4Rec's encoder, STAMP's
attention layer and Caser's convolutions.

``TransformerBlock`` and ``TransformerEncoder`` hold the JAX package's
weights under its flax names (``TransformerBlock_{i}`` with ``query``,
``key``, ``value``, ``dense``, ``ffn_1``, ``ffn_2``, ``LayerNorm_0``,
``LayerNorm_1``) and compute what its ``ops/sequence_enc.py`` computes:
per block, multi-head self-attention with an additive mask (-1e6 where a
key may not be seen), the output projection, a residual and LayerNorm,
then an FFN, a residual and LayerNorm.

On the card, ``TransformerEncoder`` packs its blocks' weights and runs the
whole stack as one launch of the fused encoder kernel
(``ops/kernels/fused_encoder.py``) when the kernel takes the shape
(``routes_to_kernel``); on the CPU, and on the card past the kernel's
limits (L > 64, D > 128, inner > 4 D), it runs the blocks, which are the
plain version.  ``packed()`` is built from ``stack`` and
``transpose``, so autograd carries the kernel's packed gradients back to
the blocks' ``nn.Linear`` and ``nn.LayerNorm`` weights.

In training the dropout sits where the flax block puts it: on the attention
probabilities, on the output projection before its residual and on the FFN
output before its residual, inverted (kept elements scaled by 1/(1-p)).  Its
masks are the kernel's (``fused_encoder.dropout_scale``), keyed by a seed
that the train step draws from its generator once a step, so the blocks on
the CPU and the kernels on the card drop the same elements.

``GRU``, ``GRU4RecEncoder``, ``STAMPLayer`` and ``CaserEncoder`` are the
JAX package's modules of those names, weights under its flax names.  They
run in plain torch on both devices: their products are ``torch.matmul``
(the JAX package computes them outside any Pallas kernel), and Caser's
convolutions are windows times a matrix, so no cuDNN switch (TF32) reaches
them.  The classic models' dropout sites (``feature_dropout``) draw the
fused encoder's hash masks on streams of their own.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .activations import get_activation
from .dropout import (draw_seed, feature_dropout,  # noqa: F401 (the sequence models' import)
                      step_seed, view_seeds)
from .initializers import flax_fan_in_normal_, kaiming_normal_, xavier_normal_
from .kernels.fused_encoder import (ATTN_OUT_SITE, ATTN_SITE, FFN_OUT_SITE, additive_mask,
                                    attention_scores, check_rate, fused_encoder, layer_masks,
                                    routes_to_kernel)

# dropout streams (``dropout_scale``'s layer and site) of the classic models',
# NISER's and CMI's sites, on layers above every transformer layer's and IOCRec's
# (``global_attn.DROPOUT_LAYER`` 256): no two sites draw the same masks
NARM_EMB_DROPOUT, NARM_CT_DROPOUT = (257, 0), (257, 1)
STAMP_DROPOUT, NEXTITNET_DROPOUT = (257, 2), (258, 0)
NISER_ITEM_DROPOUT = (258, 1)
CMI_EMB_DROPOUT = (258, 2)


def _dense(n_in: int, n_out: int, generator: torch.Generator, bias: bool = True,
           init: str = "kaiming") -> nn.Linear:
    """flax ``Dense`` with the JAX package's init: fan-in normal kernel
    (std sqrt(2/in)), or with ``init="xavier"`` the multi-task family's
    xavier normal; zero bias."""
    layer = nn.Linear(n_in, n_out, bias=bias)
    (xavier_normal_ if init == "xavier" else kaiming_normal_)(layer.weight, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def _linear_leaves(owner: nn.Module, names) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
    """flax ``Dense`` leaves of ``owner``'s ``nn.Linear`` children ``names``."""
    leaves = []
    for name in names:
        layer = getattr(owner, name)
        leaves.append(("params", (name, "kernel"), layer.weight, True))
        if layer.bias is not None:
            leaves.append(("params", (name, "bias"), layer.bias, False))
    return leaves


class TransformerBlock(nn.Module):
    def __init__(self, hidden_size: int, n_heads: int = 2, inner_size: int = 256,
                 hidden_act: str = "gelu", layer_norm_eps: float = 1e-12,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % n_heads:
            raise ValueError(f"hidden size {hidden_size} is not divisible by n_heads={n_heads}")
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.n_heads = int(n_heads)
        self.act = get_activation(hidden_act)
        for name in ("query", "key", "value", "dense"):
            setattr(self, name, _dense(hidden_size, hidden_size, gen))
        self.ffn_1 = _dense(hidden_size, inner_size, gen)
        self.ffn_2 = _dense(inner_size, hidden_size, gen)
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.LayerNorm_1 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor, add_mask: torch.Tensor,
                masks: Tuple[Optional[torch.Tensor], ...] = (None, None, None)) -> torch.Tensor:
        """x [B, L, D], add_mask broadcastable to [B, H, L, L] -> [B, L, D].
        ``masks``: dropout factors by site (``fused_encoder.layer_masks``),
        None where there is no dropout."""
        B, L, D = x.shape
        heads = (B, L, self.n_heads, D // self.n_heads)
        q, k, v = (getattr(self, n)(x).view(heads) for n in ("query", "key", "value"))
        probs = torch.softmax(attention_scores(q, k, add_mask), dim=-1)
        if masks[ATTN_SITE] is not None:
            probs = probs * masks[ATTN_SITE]
        ctx = torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(B, L, D)
        a = self.dense(ctx)
        if masks[ATTN_OUT_SITE] is not None:
            a = a * masks[ATTN_OUT_SITE]
        x = self.LayerNorm_0(a + x)
        f = self.ffn_2(self.act(self.ffn_1(x)))
        if masks[FFN_OUT_SITE] is not None:
            f = f * masks[FFN_OUT_SITE]
        return self.LayerNorm_1(f + x)

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        leaves = _linear_leaves(self, ("query", "key", "value", "dense", "ffn_1", "ffn_2"))
        for name in ("LayerNorm_0", "LayerNorm_1"):
            norm = getattr(self, name)
            leaves += [("params", (name, "scale"), norm.weight, False),
                       ("params", (name, "bias"), norm.bias, False)]
        return leaves


class TransformerEncoder(nn.Module):
    def __init__(self, hidden_size: int, n_layers: int = 2, n_heads: int = 2,
                 inner_size: int = 256, hidden_dropout_prob: float = 0.5,
                 attn_dropout_prob: float = 0.5, hidden_act: str = "gelu",
                 layer_norm_eps: float = 1e-12,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.n_heads = int(n_heads)
        self.hidden_act = hidden_act
        self.layer_norm_eps = float(layer_norm_eps)
        self.hidden_dropout_prob = float(hidden_dropout_prob)
        self.attn_dropout_prob = float(attn_dropout_prob)
        check_rate(self.hidden_dropout_prob)
        check_rate(self.attn_dropout_prob)
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden_size, n_heads, inner_size, hidden_act, layer_norm_eps, gen)
            for _ in range(n_layers))

    def packed(self) -> Tuple[torch.Tensor, ...]:
        """The blocks' weights in the kernel's layout (the JAX package's
        ``pack_params``: flax ``[in, out]`` kernels stacked by layer)."""
        layers = len(self.blocks)

        def stack(tensors, *shape):
            return torch.stack(list(tensors)).view(layers, *shape)

        attn = [getattr(b, n) for b in self.blocks for n in ("query", "key", "value", "dense")]
        D = attn[0].weight.shape[0]
        inner = self.blocks[0].ffn_1.weight.shape[0]
        norms = [getattr(b, n) for b in self.blocks for n in ("LayerNorm_0", "LayerNorm_1")]
        return (stack((m.weight for m in attn), 4, D, D).transpose(-1, -2).contiguous(),
                stack((m.bias for m in attn), 4, D),
                stack((b.ffn_1.weight for b in self.blocks), inner, D)
                .transpose(-1, -2).contiguous(),
                stack((b.ffn_1.bias for b in self.blocks), inner),
                stack((b.ffn_2.weight for b in self.blocks), D, inner)
                .transpose(-1, -2).contiguous(),
                stack((b.ffn_2.bias for b in self.blocks), D),
                stack((m.weight for m in norms), 2, D),
                stack((m.bias for m in norms), 2, D))

    def forward(self, x: torch.Tensor, key_valid: torch.Tensor, causal: bool = True,
                train: bool = False, seed: Optional[int] = None) -> torch.Tensor:
        """x [B, L, D], key_valid [B, L] (nonzero = a valid key) -> [B, L, D].
        Query l may see key j when j is valid and, if ``causal``, j <= l.
        ``train`` applies dropout with the masks of ``seed`` (drawn from
        torch's default generator when None), sample i with row
        ``seed.first_row + i``'s for a ``RowSeed``."""
        hidden = self.hidden_dropout_prob if train else 0.0
        attn = self.attn_dropout_prob if train else 0.0
        if (hidden > 0 or attn > 0) and seed is None:
            seed = draw_seed()
        first = getattr(seed, "first_row", 0)
        seed = 0 if seed is None else int(seed)
        B, L, D = x.shape
        inner = self.blocks[0].ffn_1.weight.shape[0]
        if routes_to_kernel(x.device, L, D, inner, len(self.blocks)):
            return fused_encoder(x, key_valid, self.packed(), self.n_heads, causal,
                                 self.hidden_act, self.layer_norm_eps, train, hidden, attn, seed,
                                 first)
        add_mask = additive_mask(key_valid, causal)
        for li, block in enumerate(self.blocks):
            x = block(x, add_mask, layer_masks(seed, B, li, L, D, self.n_heads, hidden, attn,
                                               x.device, first))
        return x

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        return [(c, (f"TransformerBlock_{i}",) + p, t, tr)
                for i, block in enumerate(self.blocks) for c, p, t, tr in block.jax_leaves()]


class BERT4RecEncoder(nn.Module):
    """The bidirectional encoder of CLRec and ContraRec: learned positions,
    a post-LN stack of ``num_layers`` blocks (relu FFN of width H, no
    dropout, LayerNorm eps 1e-5) over the first ``length`` positions of
    each history, read at its last one.

    Position l of a history gets the table's row l when l < length and row
    0 otherwise: a dense select, not a gather, so its backward is a batch
    reduction.  Weights: ``p_embeddings/embedding`` and
    ``TransformerEncoder_0/...``, as in the JAX package."""

    def __init__(self, max_his: int, hidden_size: int, num_layers: int = 2,
                 num_heads: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.p_embeddings = nn.Parameter(torch.empty(max_his + 1, hidden_size))
        kaiming_normal_(self.p_embeddings, gen)  # torch's fan-in: H
        self.encoder = TransformerEncoder(hidden_size, num_layers, num_heads,
                                          inner_size=hidden_size, hidden_dropout_prob=0.0,
                                          attn_dropout_prob=0.0, hidden_act="relu",
                                          layer_norm_eps=1e-5, generator=gen)

    def forward(self, seq: torch.Tensor, lengths: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """seq [B, L, H], lengths [B] -> [B, H]; a history of length 0 gives
        a zero row."""
        B, L, _ = seq.shape
        valid = torch.arange(L, device=seq.device)[None, :] < lengths[:, None]
        p = torch.where(valid[..., None], self.p_embeddings[None, :L],
                        self.p_embeddings[0][None, None])
        x = self.encoder(seq + p, valid, causal=False, train=train)
        x = x * valid[..., None]
        idx = (lengths - 1).clamp(0, L - 1).long()
        return x[torch.arange(B, device=seq.device), idx]

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        return ([("params", ("p_embeddings", "embedding"), self.p_embeddings, False)]
                + [(c, ("TransformerEncoder_0",) + p, t, tr)
                   for c, p, t, tr in self.encoder.jax_leaves()])


# --------------------------------------------------------------------------- #
# recurrent
# --------------------------------------------------------------------------- #
class GRULayer(nn.Module):
    """One flax ``GRUCell`` layer (``gru_l{i}``): kernels in flax's ``[in,
    out]`` layout, the input ones ``ir``, ``iz``, ``in`` with biases, the
    recurrent ones ``hr``, ``hz`` without and ``hn`` with one.  Init as the
    JAX package's: fan-in normal input kernels, orthogonal recurrent ones,
    zero biases."""

    GATES = ("r", "z", "n")

    def __init__(self, input_size: int, hidden_size: int, generator: torch.Generator):
        super().__init__()
        for g in self.GATES:
            kernel = nn.Parameter(torch.empty(input_size, hidden_size))
            flax_fan_in_normal_(kernel, generator)
            setattr(self, f"i{g}_kernel", kernel)
            setattr(self, f"i{g}_bias", nn.Parameter(torch.zeros(hidden_size)))
            kernel = nn.Parameter(torch.empty(hidden_size, hidden_size))
            nn.init.orthogonal_(kernel, generator=generator)
            setattr(self, f"h{g}_kernel", kernel)
        self.hn_bias = nn.Parameter(torch.zeros(hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, L, in] -> every step's carry [B, L, H], from a zero carry.
        The input products of all L steps are one product; then a step is
        r = sigmoid(x W_ir + b_ir + h W_hr), z = sigmoid(x W_iz + b_iz +
        h W_hz), n = tanh(x W_in + b_in + r (h W_hn + b_hn)),
        h' = (1 - z) n + z h, as flax computes it."""
        B, L, _ = x.shape
        w_i, b_i, w_h, b_h = self._packed()
        # unbind and split, not indexing: a slice's backward writes a zero
        # tensor of its whole source, [B, L, 3H] each step
        gi = (torch.matmul(x, w_i) + b_i).unbind(dim=1)               # L x [B, 3H]
        h = x.new_zeros(B, self.hn_bias.shape[0])
        out = []
        for t in range(L):
            h = self._step(gi[t], h, w_h, b_h)
            out.append(h)
        return torch.stack(out, dim=1)

    def _packed(self) -> Tuple[torch.Tensor, ...]:
        """The gates' kernels side by side, input [in, 3H] and recurrent
        [H, 3H], and their biases (the recurrent one hn's alone: hr and hz
        have none)."""
        H = self.hn_bias.shape[0]
        w_i = torch.cat([getattr(self, f"i{g}_kernel") for g in self.GATES], dim=1)
        b_i = torch.cat([getattr(self, f"i{g}_bias") for g in self.GATES])
        w_h = torch.cat([getattr(self, f"h{g}_kernel") for g in self.GATES], dim=1)
        return w_i, b_i, w_h, torch.cat([self.hn_bias.new_zeros(2 * H), self.hn_bias])

    @staticmethod
    def _step(gi: torch.Tensor, h: torch.Tensor, w_h: torch.Tensor,
              b_h: torch.Tensor) -> torch.Tensor:
        """The new carry from the input products ``gi`` [N, 3H] and ``h``."""
        H = h.shape[1]
        gi_rz, gi_n = gi.split([2 * H, H], dim=1)
        gh_rz, gh_n = torch.addmm(b_h, h, w_h).split([2 * H, H], dim=1)
        r, z = torch.sigmoid(gi_rz + gh_rz).chunk(2, dim=1)
        n = torch.tanh(gi_n + r * gh_n)
        return (1.0 - z) * n + z * h

    def cell(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One step of flax's ``GRUCell(carry=h, inputs=x)``: [N, in], [N, H]
        -> the new carry [N, H]."""
        w_i, b_i, w_h, b_h = self._packed()
        return self._step(torch.matmul(x, w_i) + b_i, h, w_h, b_h)

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        leaves = []
        for g in self.GATES:
            leaves += [("params", (f"i{g}", "kernel"), getattr(self, f"i{g}_kernel"), False),
                       ("params", (f"i{g}", "bias"), getattr(self, f"i{g}_bias"), False),
                       ("params", (f"h{g}", "kernel"), getattr(self, f"h{g}_kernel"), False)]
        return leaves + [("params", ("hn", "bias"), self.hn_bias, False)]


class GRU(nn.Module):
    """The JAX package's multi-layer ``GRU``: layer i (``gru_l{i}``) runs
    over every step of layer i - 1's outputs, padded steps included.  Its
    ``use_bias`` field never reaches the cell, so every layer has the input
    biases and ``hn``'s (NARM's ``use_bias=False`` GRU too)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.layers = nn.ModuleList(
            GRULayer(input_size if i == 0 else hidden_size, hidden_size, gen)
            for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, L, in] -> the last layer's outputs [B, L, H]."""
        for layer in self.layers:
            x = layer(x)
        return x

    @staticmethod
    def last_carry(outputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """The carry flax's ``nn.RNN(seq_lengths=lengths)`` returns: the
        output at step ``lengths - 1`` taken modulo L, so an empty history
        reads the carry after all L steps (``_select_last_carry``'s index
        -1).  ``seq_lengths`` freezes nothing: the steps past a history's
        end still ran over its padded positions."""
        L = outputs.shape[1]
        idx = torch.remainder(lengths.clamp(0, L).long() - 1, L)
        return outputs[torch.arange(outputs.shape[0], device=outputs.device), idx]

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        return [(c, (f"gru_l{i}",) + p, t, tr)
                for i, layer in enumerate(self.layers) for c, p, t, tr in layer.jax_leaves()]


class GRU4RecEncoder(nn.Module):
    """GRU4Rec's encoder: a ``GRU`` (``GRU_0``) of ``num_layers`` over the
    sequence, its last layer's carry at each history's last position
    (``GRU.last_carry``; the JAX package builds a prefix mask from
    ``lengths``, so a mask that is not a prefix still counts its ones), then
    a Dense ``out`` without bias back to the embedding width."""

    def __init__(self, embedding_dim: int, hidden_size: int = 128, num_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.gru = GRU(embedding_dim, hidden_size, num_layers, gen)
        self.out = _dense(hidden_size, embedding_dim, gen, bias=False)

    def forward(self, seq: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """seq [B, L, D], lengths [B] -> [B, D]."""
        return self.out(GRU.last_carry(self.gru(seq), lengths))

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        return ([(c, ("GRU_0",) + p, t, tr) for c, p, t, tr in self.gru.jax_leaves()]
                + _linear_leaves(self, ("out",)))


# --------------------------------------------------------------------------- #
# STAMP
# --------------------------------------------------------------------------- #
class STAMPLayer(nn.Module):
    """STAMP's attention layer: padding from ``lens`` as a prefix, the
    history's mean over ``max(lens, 1)``, its last item x_t (position
    ``clip(lens - 1, 0, L - 1)``), attention weights sigmoid(W_i x + W_t x_t
    + b_t + W_s m_s) W_e over the valid positions, then (W_a m_a + b_a) *
    (W_t' x_t + b_t').  ``attn_t``, ``fc_a`` and ``fc_t`` have biases;
    ``attn_i``, ``attn_s`` and ``attn_e`` do not.  ``feat_drop`` drops the
    input embeddings in training (``STAMP_DROPOUT``'s masks)."""

    def __init__(self, embedding_dim: int, feat_drop: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        D = embedding_dim
        self.feat_drop = float(feat_drop)
        check_rate(self.feat_drop)
        self.attn_i = _dense(D, D, gen, bias=False)
        self.attn_t = _dense(D, D, gen)
        self.attn_s = _dense(D, D, gen, bias=False)
        self.attn_e = _dense(D, 1, gen, bias=False)
        self.fc_a = _dense(D, D, gen)
        self.fc_t = _dense(D, D, gen)

    def forward(self, emb_seqs: torch.Tensor, lens: torch.Tensor, train: bool = False,
                seed: int = 0) -> torch.Tensor:
        """emb_seqs [B, L, D], lens [B] -> [B, D]."""
        if train:
            emb_seqs = feature_dropout(emb_seqs, self.feat_drop, seed, STAMP_DROPOUT)
        B, L, D = emb_seqs.shape
        pad = torch.arange(L, device=emb_seqs.device)[None, :] >= lens[:, None]
        emb_seqs = emb_seqs.masked_fill(pad[..., None], 0.0)
        ms = emb_seqs.sum(dim=1) / lens.clamp(min=1)[:, None].to(emb_seqs.dtype)
        idx = (lens - 1).clamp(0, L - 1).long()
        xt = emb_seqs[torch.arange(B, device=emb_seqs.device), idx]
        e = self.attn_e(torch.sigmoid(self.attn_i(emb_seqs) + self.attn_t(xt)[:, None, :]
                                      + self.attn_s(ms)[:, None, :]))[..., 0]
        alpha = e.masked_fill(pad, 0.0)[..., None]
        ma = (alpha * emb_seqs).sum(dim=1)
        return self.fc_a(ma) * self.fc_t(xt)

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        return _linear_leaves(self, ("attn_i", "attn_t", "attn_s", "attn_e", "fc_a", "fc_t"))


# --------------------------------------------------------------------------- #
# Caser
# --------------------------------------------------------------------------- #
class CaserEncoder(nn.Module):
    """Caser's convolutions (ContraRec's Caser encoder).  The kernels keep
    flax's NHWC layout ``[kh, kw, in, out]`` (in = 1): ``conv_v`` is
    ``[max_his, 1, 1, nv]``, ``conv_h{i}`` ``[i, D, 1, nh]`` for i = 1..l.
    Each convolution is its input windows times its kernel as a matrix.
    The sequence is zero-padded to ``max_his``; ``conv_v``'s output [B, D,
    nv] is flattened D-major, then by channel, as flax flattens [B, 1, D,
    nv]; each ``conv_h{i}`` is followed by relu and a maximum over time;
    ``fc`` maps the ``nv D + l nh`` features back to D."""

    def __init__(self, max_his: int, embedding_dim: int, num_horizon: int = 16,
                 num_vertical: int = 8, l: int = 5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        D = embedding_dim
        self.max_his, self.l = int(max_his), int(l)
        self.conv_v_kernel = nn.Parameter(torch.empty(max_his, 1, 1, num_vertical))
        self.conv_v_bias = nn.Parameter(torch.zeros(num_vertical))
        flax_fan_in_normal_(self.conv_v_kernel, gen)
        for i in range(1, self.l + 1):
            kernel = nn.Parameter(torch.empty(i, D, 1, num_horizon))
            flax_fan_in_normal_(kernel, gen)
            setattr(self, f"conv_h{i}_kernel", kernel)
            setattr(self, f"conv_h{i}_bias", nn.Parameter(torch.zeros(num_horizon)))
        self.fc = _dense(num_vertical * D + self.l * num_horizon, D, gen)

    def forward(self, seq: torch.Tensor, lengths: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """seq [B, L, D] with L <= max_his -> [B, D]; ``lengths`` is not read
        (the JAX package's signature)."""
        B, L, D = seq.shape
        if L > self.max_his:
            raise ValueError(f"Caser takes at most max_his={self.max_his} positions, got {L}")
        x = F.pad(seq, (0, 0, 0, self.max_his - L))                    # [B, M, D]
        nv = self.conv_v_bias.shape[0]
        out_v = torch.matmul(x.transpose(1, 2), self.conv_v_kernel.reshape(self.max_his, nv))
        feats = [(out_v + self.conv_v_bias).reshape(B, D * nv)]
        for i in range(1, self.l + 1):
            kernel = getattr(self, f"conv_h{i}_kernel")
            T = self.max_his - i + 1
            windows = torch.cat([x[:, a:a + T] for a in range(i)], dim=-1)  # [B, T, i D]
            h = torch.matmul(windows, kernel.reshape(i * D, -1)) + getattr(self, f"conv_h{i}_bias")
            feats.append(torch.relu(h).amax(dim=1))
        return self.fc(torch.cat(feats, dim=1))

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        leaves = [("params", ("conv_v", "kernel"), self.conv_v_kernel, False),
                  ("params", ("conv_v", "bias"), self.conv_v_bias, False)]
        for i in range(1, self.l + 1):
            leaves += [("params", (f"conv_h{i}", "kernel"), getattr(self, f"conv_h{i}_kernel"),
                        False),
                       ("params", (f"conv_h{i}", "bias"), getattr(self, f"conv_h{i}_bias"),
                        False)]
        return leaves + _linear_leaves(self, ("fc",))
