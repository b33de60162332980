"""Activation resolver over the same name table as the JAX package.

flax's ``gelu`` is the tanh approximation, so ``"gelu"`` here is too.
``Dice`` has parameters and is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F


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
        raise ValueError("Dice has parameters and is not ported yet")
    if name not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation: {activation!r}")
    return _ACTIVATIONS[name]
