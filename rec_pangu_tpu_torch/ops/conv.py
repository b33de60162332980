"""NextItNet's dilated causal convolutions and CCPM's convolution stack, the
JAX package's ``ops/conv.py`` (``MaskedConv1d``, ``ResBlockTwoMasked``,
``ResBlockOneMasked``, ``NextItNetLayer``, ``CCPMConvLayer``), weights under
its flax names.

A convolution keeps flax's kernel layout ``[k, in, out]`` and runs as one
product: the k inputs each output position sees, side by side, times the
kernel as a ``[k * in, out]`` matrix.  That is plain ``torch.matmul`` (the
JAX package computes it outside any Pallas kernel), so cuDNN's TF32 switch
does not reach it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import flax_fan_in_normal_
from .pooling import kmax_pooling
from .sequence_enc import NEXTITNET_DROPOUT, _dense, _linear_leaves, feature_dropout
from .kernels.fused_encoder import check_rate

LN_EPS = 1e-5  # the residual blocks' LayerNorms (not the encoders' 1e-3)


class MaskedConv1d(nn.Module):
    """Causal dilated 1-D convolution over [B, L, C]: a left pad of
    ``(k - 1) * dilation``, so output t sees inputs t - (k - 1 - j) * d for
    j < k.  Weights ``Conv_0/kernel`` [k, in, out] and ``Conv_0/bias``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dilation = int(dilation)
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_channels, out_channels))
        flax_fan_in_normal_(self.kernel, gen)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, L, in] -> [B, L, out]."""
        k, c_in, _ = self.kernel.shape
        L = x.shape[1]
        taps = []
        for j in range(k):
            shift = (k - 1 - j) * self.dilation  # tap j reads `shift` steps back
            taps.append(F.pad(x, (0, 0, shift, 0))[:, :L] if shift else x)
        return torch.matmul(torch.cat(taps, dim=-1), self.kernel.reshape(k * c_in, -1)) + self.bias

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        return [("params", ("Conv_0", "kernel"), self.kernel, False),
                ("params", ("Conv_0", "bias"), self.bias, False)]


def _norms(owner: nn.Module, widths: Sequence[int]) -> None:
    owner.norms = nn.ModuleList(nn.LayerNorm(w, eps=LN_EPS) for w in widths)


def _norm_leaves(norms: nn.ModuleList) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
    leaves = []
    for i, norm in enumerate(norms):
        leaves += [("params", (f"LayerNorm_{i}", "scale"), norm.weight, False),
                   ("params", (f"LayerNorm_{i}", "bias"), norm.bias, False)]
    return leaves


class ResBlockTwoMasked(nn.Module):
    """causal conv(d) -> LayerNorm -> relu -> causal conv(2 d) -> LayerNorm
    -> relu -> + x, over [B, L, C]."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.convs = nn.ModuleList([
            MaskedConv1d(channels, channels, kernel_size, dilation, gen),
            MaskedConv1d(channels, channels, kernel_size, 2 * dilation, gen)])
        _norms(self, (channels, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for conv, norm in zip(self.convs, self.norms):
            y = torch.relu(norm(conv(y)))
        return y + x

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        return ([(c, (f"MaskedConv1d_{i}",) + p, t, tr)
                 for i, conv in enumerate(self.convs) for c, p, t, tr in conv.jax_leaves()]
                + _norm_leaves(self.norms))


class ResBlockOneMasked(nn.Module):
    """The bottleneck block, pre-activation: relu(LN(x)) -> Dense to C/2 ->
    relu(LN) -> causal conv(d) -> relu(LN) -> Dense to C -> + x."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        mid = channels // 2
        _norms(self, (channels, mid, mid))
        self.Dense_0 = _dense(channels, mid, gen)
        self.conv = MaskedConv1d(mid, mid, kernel_size, dilation, gen)
        self.Dense_1 = _dense(mid, channels, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Dense_0(torch.relu(self.norms[0](x)))
        y = self.conv(torch.relu(self.norms[1](y)))
        return self.Dense_1(torch.relu(self.norms[2](y))) + x

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        return (_linear_leaves(self, ("Dense_0", "Dense_1")) + _norm_leaves(self.norms)
                + [(c, ("MaskedConv1d_0",) + p, t, tr) for c, p, t, tr in self.conv.jax_leaves()])


class NextItNetLayer(nn.Module):
    """The dilated causal stack: padding (from ``lens`` as a prefix) set to
    zero, ``feat_drop`` in training (``NEXTITNET_DROPOUT``'s masks), one
    residual block a dilation (``ResBlockTwoMasked`` at (1, 4) by default,
    ``ResBlockOneMasked`` at (1, 2, 4) with ``one_masked``), then the state
    at ``clip(lens - 1, 0, L - 1)``."""

    def __init__(self, channels: int, dilations: Optional[Sequence[int]] = None,
                 one_masked: bool = False, kernel_size: int = 3, feat_drop: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        dilations = dilations or ((1, 2, 4) if one_masked else (1, 4))
        block = ResBlockOneMasked if one_masked else ResBlockTwoMasked
        self.block_name = block.__name__
        self.feat_drop = float(feat_drop)
        check_rate(self.feat_drop)
        self.blocks = nn.ModuleList(block(channels, kernel_size, d, gen) for d in dilations)

    def forward(self, emb_seqs: torch.Tensor, lens: torch.Tensor, train: bool = False,
                seed: int = 0) -> torch.Tensor:
        """emb_seqs [B, L, C], lens [B] -> [B, C]."""
        B, L, _ = emb_seqs.shape
        pad = torch.arange(L, device=emb_seqs.device)[None, :] >= lens[:, None]
        x = emb_seqs.masked_fill(pad[..., None], 0.0)
        if train:
            x = feature_dropout(x, self.feat_drop, seed, NEXTITNET_DROPOUT)
        for block in self.blocks:
            x = block(x)
        idx = (lens - 1).clamp(0, L - 1).long()
        return x[torch.arange(B, device=x.device), idx]

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        return [(c, (f"{self.block_name}_{j}",) + p, t, tr)
                for j, block in enumerate(self.blocks) for c, p, t, tr in block.jax_leaves()]


class CCPMConvLayer(nn.Module):
    """CCPM's stack over [B, F, D] -> [B, 3, D, channels[-1]], NHWC with the
    field as H and the embedding as W: per layer, zero-pad the fields by
    kh - 1 on both sides, a (kh, 1) convolution (``Conv_{i}``, kernel in
    flax's layout ``[kh, 1, in, out]``, contracted here: ``convert.py``
    keeps leaves of more than three axes as they are), k-max pooling over
    the fields (k from the reference's schedule, 3 at the last layer) and
    tanh."""

    def __init__(self, num_fields: int, channels: Sequence[int] = (3,),
                 kernel_heights: Sequence[int] = (3,),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.num_fields = int(num_fields)
        self.kernels = nn.ParameterList()
        self.biases = nn.ParameterList()
        c_in = 1
        for ch, kh in zip(channels, kernel_heights):
            kernel = nn.Parameter(torch.empty(kh, 1, c_in, ch))
            flax_fan_in_normal_(kernel, gen)
            self.kernels.append(kernel)
            self.biases.append(nn.Parameter(torch.zeros(ch)))
            c_in = ch

    def pool_sizes(self) -> List[int]:
        """k of each layer's k-max pooling."""
        layers = len(self.kernels)
        return [max(3, int((1 - pow(float(i) / layers, layers - i)) * self.num_fields))
                if i < layers else 3 for i in range(1, layers + 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[..., None]                                          # [B, F, D, 1]
        for kernel, bias, k in zip(self.kernels, self.biases, self.pool_sizes()):
            kh = kernel.shape[0]
            x = F.pad(x, (0, 0, 0, 0, kh - 1, kh - 1))
            windows = x.unfold(1, kh, 1)                          # [B, H, D, C, kh]
            x = torch.einsum("bhdck,kco->bhdo", windows, kernel[:, 0]) + bias
            x = torch.tanh(kmax_pooling(x, k, dim=1))
        return x

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        leaves = []
        for i, (k, b) in enumerate(zip(self.kernels, self.biases)):
            leaves += [("params", (f"Conv_{i}", "kernel"), k, False),
                       ("params", (f"Conv_{i}", "bias"), b, False)]
        return leaves
