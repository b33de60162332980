"""Feature-interaction layers of the ranking models, the JAX package's
``ops/interactions.py``, weights under its flax names.

* ``inner_product``: the FM inner product, four output modes.
* ``CrossNet`` (DCN): X_{i+1} = X_i + (X_i w_i) X_0 + b_i.
* ``CompressedInteractionNet`` (xDeepFM's CIN): each layer the outer product
  of X_0 [B, F, D] and X_i [B, H_i, D] along the fields, contracted over the
  ``F * H_i`` channels (channel ``f * H_i + m``, the reference's order) in
  one product, then summed over D; a Dense of the layers' sums.
* ``SENETLayer`` and ``BilinearInteraction`` (FiBiNet).
* ``MaskBlock`` (MaskNet): LayerNorm(net) times a mask MLP of the mask
  input, a Dense and a LayerNorm (both eps 1e-5, torch's).
* ``FMLayer``, ``InteractionMachine`` and ``HolographicInteraction``: layers
  no model of the package builds, kept for its layer library.

Every product is ``torch.matmul``/``einsum``: the JAX package computes them
outside any Pallas kernel.  Parameters the flax code makes with
``self.param`` keep flax's layout (not transposed); its ``nn.Dense`` layers
are ``nn.Linear``, fan-in normal kernels and zero biases, as flax inits them
with the package's ``KERNEL_INIT``.
"""
from __future__ import annotations

from itertools import combinations
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..convert import prefixed
from .activations import get_activation
from .initializers import flax_fan_in_normal_
from .mlp import BN_EPS, BN_MOMENTUM, bn_leaves, flax_batch_norm
from .sequence_enc import _dense, _linear_leaves

Leaves = List[Tuple[str, tuple, torch.Tensor, bool]]
LN_EPS = 1e-5


def _pair_indices(num_fields: int, device: torch.device):
    p, q = zip(*combinations(range(num_fields), 2))
    return (torch.tensor(p, dtype=torch.long, device=device),
            torch.tensor(q, dtype=torch.long, device=device))


def _gen(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def _flax_param(*shape: int, generator: torch.Generator) -> nn.Parameter:
    """A kernel in flax's layout with the package's fan-in normal init."""
    t = nn.Parameter(torch.empty(*shape))
    flax_fan_in_normal_(t, generator)
    return t


def inner_product(feature_emb: torch.Tensor,
                  output: str = "product_sum_pooling") -> torch.Tensor:
    """FM pairwise interactions over [B, F, D].

    Modes: product_sum_pooling [B, 1]; Bi_interaction_pooling [B, D];
    inner_product [B, F(F-1)/2]; elementwise_product [B, F(F-1)/2, D].
    """
    if output in ("product_sum_pooling", "Bi_interaction_pooling"):
        sum_of_square = feature_emb.sum(dim=1) ** 2
        square_of_sum = (feature_emb ** 2).sum(dim=1)
        bi = (sum_of_square - square_of_sum) * 0.5
        if output == "Bi_interaction_pooling":
            return bi
        return bi.sum(dim=-1, keepdim=True)
    if output not in ("elementwise_product", "inner_product"):
        raise ValueError(f"inner_product output={output!r} is not supported")
    p, q = _pair_indices(feature_emb.shape[1], feature_emb.device)
    prod = feature_emb[:, p, :] * feature_emb[:, q, :]
    if output == "elementwise_product":
        return prod
    return prod.sum(dim=-1)


class CrossNet(nn.Module):
    """DCN's cross network over [B, D]; weights ``w_{i}`` [D, 1] and
    ``b_{i}`` [D]."""

    def __init__(self, input_dim: int, num_layers: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(generator)
        self.w = nn.ParameterList(_flax_param(input_dim, 1, generator=gen)
                                  for _ in range(num_layers))
        self.b = nn.ParameterList(nn.Parameter(torch.zeros(input_dim))
                                  for _ in range(num_layers))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        xi = x0
        for w, b in zip(self.w, self.b):
            xi = xi + torch.matmul(xi, w) * x0 + b
        return xi

    def jax_leaves(self) -> Leaves:
        leaves = []
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            leaves += [("params", (f"w_{i}",), w, False), ("params", (f"b_{i}",), b, False)]
        return leaves


class CompressedInteractionNet(nn.Module):
    """xDeepFM's CIN over [B, F, D] -> [B, output_dim]; weights
    ``conv_{i}_kernel`` [F * H_i, units], ``conv_{i}_bias`` and ``Dense_0``."""

    def __init__(self, num_fields: int, cin_layer_units: Sequence[int], output_dim: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(generator)
        self.num_fields = int(num_fields)
        self.kernels = nn.ParameterList()
        self.biases = nn.ParameterList()
        h = self.num_fields
        for units in cin_layer_units:
            self.kernels.append(_flax_param(self.num_fields * h, units, generator=gen))
            self.biases.append(nn.Parameter(torch.zeros(units)))
            h = units
        self.Dense_0 = _dense(sum(cin_layer_units), output_dim, gen)

    def forward(self, feature_emb: torch.Tensor) -> torch.Tensor:
        x0 = xi = feature_emb
        pooled = []
        for kernel, bias in zip(self.kernels, self.biases):
            k3 = kernel.view(self.num_fields, xi.shape[1], -1)
            # the outer product first, then one product over its F * H_i
            # channels: a fixed order (a three-operand einsum picks one by
            # the shapes, the batch's too, which torch.export cannot trace)
            outer = x0.unsqueeze(2) * xi.unsqueeze(1)                  # [B, F, H_i, D]
            xi = torch.einsum("bfmd,fmo->bod", outer, k3) + bias[None, :, None]
            pooled.append(xi.sum(dim=-1))
        return self.Dense_0(torch.cat(pooled, dim=-1))

    def jax_leaves(self) -> Leaves:
        leaves = []
        for i, (k, b) in enumerate(zip(self.kernels, self.biases)):
            leaves += [("params", (f"conv_{i}_kernel",), k, False),
                       ("params", (f"conv_{i}_bias",), b, False)]
        return leaves + _linear_leaves(self, ("Dense_0",))


class SENETLayer(nn.Module):
    """Squeeze-excitation over the fields: each field's embedding scaled by
    relu(Dense_1(relu(Dense_0(mean over D)))), both Dense without bias."""

    def __init__(self, num_fields: int, reduction_ratio: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(generator)
        reduced = max(1, num_fields // reduction_ratio)
        self.Dense_0 = _dense(num_fields, reduced, gen, bias=False)
        self.Dense_1 = _dense(reduced, num_fields, gen, bias=False)

    def forward(self, feature_emb: torch.Tensor) -> torch.Tensor:
        a = torch.relu(self.Dense_0(feature_emb.mean(dim=-1)))
        a = torch.relu(self.Dense_1(a))
        return feature_emb * a[..., None]

    def jax_leaves(self) -> Leaves:
        return _linear_leaves(self, ("Dense_0", "Dense_1"))


class BilinearInteraction(nn.Module):
    """FiBiNet's bilinear interaction over field pairs -> [B, F(F-1)/2, D];
    ``weight`` [D, D] ("field_all"), [F, D, D] ("field_each") or
    [F(F-1)/2, D, D] ("field_interaction")."""

    def __init__(self, num_fields: int, embedding_dim: int,
                 bilinear_type: str = "field_interaction",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(generator)
        D = embedding_dim
        shapes = {"field_all": (D, D), "field_each": (num_fields, D, D),
                  "field_interaction": (num_fields * (num_fields - 1) // 2, D, D)}
        if bilinear_type not in shapes:
            raise NotImplementedError(bilinear_type)
        self.bilinear_type = bilinear_type
        self.weight = _flax_param(*shapes[bilinear_type], generator=gen)

    def forward(self, feature_emb: torch.Tensor) -> torch.Tensor:
        p, q = _pair_indices(feature_emb.shape[1], feature_emb.device)
        if self.bilinear_type == "field_all":
            proj = torch.matmul(feature_emb, self.weight)[:, p]
        elif self.bilinear_type == "field_each":
            proj = torch.einsum("bfd,fde->bfe", feature_emb, self.weight)[:, p]
        else:
            proj = torch.einsum("bpd,pde->bpe", feature_emb[:, p], self.weight)
        return proj * feature_emb[:, q]

    def jax_leaves(self) -> Leaves:
        return [("params", ("weight",), self.weight, False)]


class MaskBlock(nn.Module):
    """MaskNet's block: Dense_2(LayerNorm_0(net) * Dense_1(relu(Dense_0(
    mask_input)))), then LayerNorm_1."""

    def __init__(self, input_dim: int, mask_input_dim: int, output_size: int,
                 reduction_factor: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(generator)
        agg = int(mask_input_dim * reduction_factor)
        self.LayerNorm_0 = nn.LayerNorm(input_dim, eps=LN_EPS)
        self.Dense_0 = _dense(mask_input_dim, agg, gen)
        self.Dense_1 = _dense(agg, input_dim, gen)
        self.Dense_2 = _dense(input_dim, output_size, gen)
        self.LayerNorm_1 = nn.LayerNorm(output_size, eps=LN_EPS)

    def forward(self, net: torch.Tensor, mask_input: torch.Tensor) -> torch.Tensor:
        mask = self.Dense_1(torch.relu(self.Dense_0(mask_input)))
        return self.LayerNorm_1(self.Dense_2(self.LayerNorm_0(net) * mask))

    def jax_leaves(self) -> Leaves:
        leaves = _linear_leaves(self, ("Dense_0", "Dense_1", "Dense_2"))
        for name in ("LayerNorm_0", "LayerNorm_1"):
            norm = getattr(self, name)
            leaves += prefixed(name, [("params", ("scale",), norm.weight, False),
                                      ("params", ("bias",), norm.bias, False)])
        return leaves


class FMLayer(nn.Module):
    """``inner_product``'s product_sum_pooling [B, 1], then
    ``final_activation`` (a name of ``get_activation``; none when empty)."""

    def __init__(self, final_activation: str = ""):
        super().__init__()
        self.final_activation = get_activation(final_activation) if final_activation else None

    def forward(self, feature_emb: torch.Tensor) -> torch.Tensor:
        out = inner_product(feature_emb, "product_sum_pooling")
        return self.final_activation(out) if self.final_activation is not None else out

    def jax_leaves(self) -> Leaves:
        return []


class InteractionMachine(nn.Module):
    """The interactions of orders 1 to ``order`` (at most 5) over [B, F, D]
    in closed form, from the power sums p_k = sum over the fields of x^k:
    [B, order * D], then flax's ``BatchNorm_0`` (momentum 0.9, eps 1e-5)
    when ``batch_norm``, and ``Dense_0`` to [B, 1]."""

    def __init__(self, embedding_dim: int, order: int = 2, batch_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 1 <= order <= 5:
            raise ValueError(f"order={order} is not supported")
        self.order = int(order)
        width = self.order * embedding_dim
        self.bn = (nn.BatchNorm1d(width, eps=BN_EPS, momentum=BN_MOMENTUM)
                   if batch_norm else None)
        self.Dense_0 = _dense(width, 1, _gen(generator))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        q = x
        p1 = q.sum(dim=1)
        out = [p1]
        if self.order >= 2:
            q = q * x
            p2 = q.sum(dim=1)
            out.append((p1 ** 2 - p2) / 2)
        if self.order >= 3:
            q = q * x
            p3 = q.sum(dim=1)
            out.append((p1 ** 3 - 3 * p1 * p2 + 2 * p3) / 6)
        if self.order >= 4:
            q = q * x
            p4 = q.sum(dim=1)
            out.append((p1 ** 4 - 6 * p1 ** 2 * p2 + 3 * p2 ** 2 + 8 * p1 * p3 - 6 * p4) / 24)
        if self.order == 5:
            q = q * x
            p5 = q.sum(dim=1)
            out.append((p1 ** 5 - 10 * p1 ** 3 * p2 + 20 * p1 ** 2 * p3 - 30 * p1 * p4
                        - 20 * p2 * p3 + 15 * p1 * p2 ** 2 + 24 * p5) / 120)
        h = torch.cat(out, dim=-1)
        if self.bn is not None:
            h = flax_batch_norm(h, self.bn, train)
        return self.Dense_0(h)

    def jax_leaves(self) -> Leaves:
        bn = bn_leaves("BatchNorm_0", self.bn) if self.bn is not None else []
        return _linear_leaves(self, ("Dense_0",)) + bn


class HolographicInteraction(nn.Module):
    """Pairwise interactions over [B, F, D] -> [B, F(F-1)/2, D]: the
    hadamard product, or the circular convolution or correlation of each
    field pair through ``torch.fft`` along D."""

    TYPES = ("hadamard_product", "circular_convolution", "circular_correlation")

    def __init__(self, interaction_type: str = "circular_convolution"):
        super().__init__()
        if interaction_type not in self.TYPES:
            raise ValueError(f"interaction_type={interaction_type!r} not supported")
        self.interaction_type = interaction_type

    def forward(self, feature_emb: torch.Tensor) -> torch.Tensor:
        p, q = _pair_indices(feature_emb.shape[1], feature_emb.device)
        e1, e2 = feature_emb[:, p], feature_emb[:, q]
        if self.interaction_type == "hadamard_product":
            return e1 * e2
        f1 = torch.fft.fft(e1, dim=-1)
        f2 = torch.fft.fft(e2, dim=-1)
        if self.interaction_type == "circular_correlation":
            f1 = torch.conj(f1)
        return torch.fft.ifft(f1 * f2, dim=-1).real

    def jax_leaves(self) -> Leaves:
        return []
