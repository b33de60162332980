"""Loss registry (legacy strings like ``'torch.nn.BCELoss()'`` are accepted)."""
from __future__ import annotations

from typing import Callable

import torch

EPS = 1e-7


def bce_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on probabilities.

    The clip is straight-through (value clipped, gradient of the identity),
    as in the JAX package: a saturated, confidently wrong prediction keeps
    its gradient instead of losing it to the clip."""
    p_raw = pred.reshape(label.shape)
    p = p_raw + (p_raw.clamp(EPS, 1.0 - EPS) - p_raw).detach()
    return -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p)).mean()


def mse_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    return ((pred.reshape(label.shape) - label) ** 2).mean()


_LOSSES = {
    "bce": bce_loss,
    "bceloss": bce_loss,
    "torch.nn.bceloss()": bce_loss,
    "mse": mse_loss,
    "torch.nn.mseloss()": mse_loss,
}


def get_loss_fn(name) -> Callable:
    if callable(name):
        return name
    key = str(name).lower().strip()
    if key not in _LOSSES:
        raise ValueError(f"Unknown loss: {name!r}; registered: {sorted(_LOSSES)}")
    return _LOSSES[key]
