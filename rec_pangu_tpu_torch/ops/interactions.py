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
from .initializers import flax_fan_in_normal_
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
            xi = torch.einsum("bfd,bmd,fmo->bod", x0, xi, k3) + bias[None, :, None]
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
