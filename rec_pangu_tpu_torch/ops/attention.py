"""Multi-head attention of the ranking family, the JAX package's
``ops/attention.py`` (AutoInt's self-attention), weights under its flax
names: ``W_q``, ``W_k``, ``W_v`` and, when the heads' width differs from
the input's, ``W_res``, each a Dense without bias (kaiming normal, or
xavier normal with ``init="xavier"``: AITM's).

Heads are split as ``[B, L, H, dh]``; the output is the attention over the
values, projected residual added (``align_to="output"``: the residual is
projected up to the heads' width; ``"input"``: the output is projected back
down), an optional LayerNorm (eps 1e-5) and a final relu.  The reference
drops twice at one rate: the attention probabilities and the output before
its residual.  Both draw the port's hash masks (``ops/dropout.py``) on the
streams ``(ATTENTION_DROPOUT_LAYER + block, 0)`` and ``(..., 1)``.  A
boolean mask keeps True; every score it drops is -1e6 (finite), so a row
with every key dropped is uniform over its keys, not NaN; a float mask is
added.  These are plain products, nothing to do with the fused encoder.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from .dropout import ATTENTION_DROPOUT_LAYER, draw_seed, feature_dropout
from .sequence_enc import _dense, _linear_leaves

_NEG = -1e6


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: Optional[float] = None,
                                 mask: Optional[torch.Tensor] = None,
                                 dropout: Optional[Tuple[float, int, Tuple[int, int]]] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v [..., L, dh] -> (out [..., L, dh], attention [..., L, M]).
    ``dropout`` (rate, seed, stream) drops attention probabilities."""
    att = torch.matmul(q, k.transpose(-1, -2))
    if scale:
        att = att / scale
    if mask is not None:
        att = torch.where(mask, att, _NEG) if mask.dtype == torch.bool else att + mask
    att = torch.softmax(att, dim=-1)
    if dropout is not None:
        att = feature_dropout(att, *dropout)
    return torch.matmul(att, v), att


class MultiHeadAttention(nn.Module):
    def __init__(self, input_dim: int, attention_dim: Optional[int] = None, num_heads: int = 1,
                 dropout_rate: float = 0.0, use_residual: bool = True,
                 use_scale: bool = False, layer_norm: bool = False, align_to: str = "input",
                 final_relu: bool = True, block: int = 0,
                 generator: Optional[torch.Generator] = None, init: str = "kaiming"):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.num_heads = int(num_heads)
        self.dh = int(attention_dim or input_dim // num_heads)
        output_dim = self.num_heads * self.dh
        self.dropout_rate = float(dropout_rate)
        self.use_residual, self.final_relu = use_residual, final_relu
        self.scale = self.dh ** 0.5 if use_scale else None
        self.align_to = align_to
        self.stream = ATTENTION_DROPOUT_LAYER + int(block)
        self.W_q = _dense(input_dim, output_dim, gen, bias=False, init=init)
        self.W_k = _dense(input_dim, output_dim, gen, bias=False, init=init)
        self.W_v = _dense(input_dim, output_dim, gen, bias=False, init=init)
        self.W_res = None
        if input_dim != output_dim:
            self.W_res = (_dense(input_dim, output_dim, gen, bias=False, init=init)
                          if align_to == "output"
                          else _dense(output_dim, input_dim, gen, bias=False, init=init))
        self.layer_norm = (nn.LayerNorm(output_dim if align_to == "output" else input_dim,
                                        eps=1e-5) if layer_norm else None)

    def forward(self, query, key, value, mask=None, train: bool = False,
                seed: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        rate = self.dropout_rate if train else 0.0
        if rate > 0 and seed is None:
            seed = draw_seed()
        B, L = query.shape[0], query.shape[1]

        def heads(x):
            return x.view(B, -1, self.num_heads, self.dh).transpose(1, 2)

        q, k, v = heads(self.W_q(query)), heads(self.W_k(key)), heads(self.W_v(value))
        if mask is not None and mask.dim() == 3:
            mask = mask[:, None]
        drop = (rate, seed, (self.stream, 0)) if rate > 0 else None
        out, att = scaled_dot_product_attention(q, k, v, self.scale, mask, drop)
        out = out.transpose(1, 2).reshape(B, L, self.num_heads * self.dh)
        residual = query
        if self.W_res is not None:
            if self.align_to == "output":
                residual = self.W_res(residual)
            else:
                out = self.W_res(out)
        if rate > 0:
            out = feature_dropout(out, rate, seed, (self.stream, 1))
        if self.use_residual:
            out = out + residual
        if self.layer_norm is not None:
            out = self.layer_norm(out)
        if self.final_relu:
            out = torch.relu(out)
        return out, att

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        names = ("W_q", "W_k", "W_v") + (("W_res",) if self.W_res is not None else ())
        leaves = _linear_leaves(self, names)
        if self.layer_norm is not None:
            leaves += [("params", ("LayerNorm_0", "scale"), self.layer_norm.weight, False),
                       ("params", ("LayerNorm_0", "bias"), self.layer_norm.bias, False)]
        return leaves


class MultiHeadSelfAttention(MultiHeadAttention):
    def forward(self, x, train: bool = False, seed: Optional[int] = None) -> torch.Tensor:
        return super().forward(x, x, x, train=train, seed=seed)[0]
