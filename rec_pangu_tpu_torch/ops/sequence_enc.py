"""Sequence encoders: the post-LN transformer stack, and BERT4Rec's
bidirectional encoder built on it.

``TransformerBlock`` and ``TransformerEncoder`` hold the JAX package's
weights under its flax names (``TransformerBlock_{i}`` with ``query``,
``key``, ``value``, ``dense``, ``ffn_1``, ``ffn_2``, ``LayerNorm_0``,
``LayerNorm_1``) and compute what its ``ops/sequence_enc.py`` computes:
per block, multi-head self-attention with an additive mask (-1e6 where a
key may not be seen), the output projection, a residual and LayerNorm,
then an FFN, a residual and LayerNorm.

On the card, ``TransformerEncoder`` packs its blocks' weights and runs the
whole stack as one launch of the fused encoder kernel
(``ops/kernels/fused_encoder.py``); on the CPU it runs the blocks, which
are the plain version.  ``packed()`` is built from ``stack`` and
``transpose``, so autograd carries the kernel's packed gradients back to
the blocks' ``nn.Linear`` and ``nn.LayerNorm`` weights.

In training the dropout sits where the flax block puts it: on the attention
probabilities, on the output projection before its residual and on the FFN
output before its residual, inverted (kept elements scaled by 1/(1-p)).  Its
masks are the kernel's (``fused_encoder.dropout_scale``), keyed by a seed
that the train step draws from its generator once a step, so the blocks on
the CPU and the kernels on the card drop the same elements.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from .activations import get_activation
from .initializers import kaiming_normal_
from .kernels.fused_encoder import (ATTN_OUT_SITE, ATTN_SITE, FFN_OUT_SITE, additive_mask,
                                    attention_scores, check_rate, fused_encoder, layer_masks)

_SEED_RANGE = 2 ** 31 - 1  # a step's dropout seed lies in [0, 2**31 - 1), as in JAX


def draw_seed(generator: Optional[torch.Generator] = None) -> int:
    """One dropout seed from ``generator`` (torch's default one when None)."""
    return int(torch.randint(0, _SEED_RANGE, (1,), generator=generator)[0])


def _dense(n_in: int, n_out: int, generator: torch.Generator) -> nn.Linear:
    """flax ``Dense`` with the JAX package's init: fan-in normal kernel
    (std sqrt(2/in)), zero bias."""
    layer = nn.Linear(n_in, n_out)
    kaiming_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


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
        leaves = []
        for name in ("query", "key", "value", "dense", "ffn_1", "ffn_2"):
            layer = getattr(self, name)
            leaves += [("params", (name, "kernel"), layer.weight, True),
                       ("params", (name, "bias"), layer.bias, False)]
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
        torch's default generator when None)."""
        hidden = self.hidden_dropout_prob if train else 0.0
        attn = self.attn_dropout_prob if train else 0.0
        if (hidden > 0 or attn > 0) and seed is None:
            seed = draw_seed()
        seed = 0 if seed is None else int(seed)
        if x.device.type == "cuda":
            return fused_encoder(x, key_valid, self.packed(), self.n_heads, causal,
                                 self.hidden_act, self.layer_norm_eps, train, hidden, attn, seed)
        add_mask = additive_mask(key_valid, causal)
        B, L, D = x.shape
        for li, block in enumerate(self.blocks):
            x = block(x, add_mask, layer_masks(seed, B, li, L, D, self.n_heads, hidden, attn,
                                               x.device))
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
