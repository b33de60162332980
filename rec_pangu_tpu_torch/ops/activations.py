"""Activation resolver over the same name table as the JAX package, and
``Dice``.

flax's ``gelu`` is the tanh approximation, so ``"gelu"`` here is too.
``Dice`` has parameters, so ``get_activation`` refuses it, as the JAX
package's does: an ``MLP`` builds one for a hidden layer whose activation is
``"dice"``.
"""
from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F
from torch import nn


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


_ACTIVATIONS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "leakyrelu": F.leaky_relu,
    "leaky_relu": F.leaky_relu,
    "elu": F.elu,
    "softplus": F.softplus,
    "prelu": F.leaky_relu,  # parameter-free approximation, as in the JAX table
    "identity": _identity,
    "linear": _identity,
    "none": _identity,
}


def get_activation(activation: Union[str, Callable]) -> Callable:
    """String -> activation function on tensors."""
    if callable(activation):
        return activation
    name = activation.lower()
    if name == "dice":
        raise ValueError("Dice has parameters; instantiate ops.Dice directly")
    if name not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation: {activation!r}")
    return _ACTIVATIONS[name]


class Dice(nn.Module):
    """Dice: ``p = sigmoid(BN(x)); out = p*x + (1-p)*alpha*x`` over the last
    axis of ``x``, ``alpha`` zeros ``[features]``.  The BatchNorm is flax's
    (``mlp.flax_batch_norm``) without scale or bias, eps 1e-9 and flax
    momentum 0.99 (torch's 0.01); flax names ``alpha`` and ``BatchNorm_0``'s
    ``mean``/``var``."""

    EPS = 1e-9
    MOMENTUM = 0.01

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(features))
        self.bn = nn.BatchNorm1d(features, eps=self.EPS, momentum=self.MOMENTUM, affine=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        from .mlp import flax_batch_norm

        p = torch.sigmoid(flax_batch_norm(x, self.bn, train, dims=range(x.dim() - 1)))
        return p * x + (1.0 - p) * self.alpha * x

    def jax_leaves(self):
        return [("params", ("alpha",), self.alpha, False),
                ("batch_stats", ("BatchNorm_0", "mean"), self.bn.running_mean, False),
                ("batch_stats", ("BatchNorm_0", "var"), self.bn.running_var, False)]
