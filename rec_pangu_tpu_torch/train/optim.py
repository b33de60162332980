"""Optimizer and learning-rate schedule, as the JAX package builds them.

The schedules decay once per EPOCH (StepLR, ExponentialLR,
CosineAnnealingLR with torch's parameter names and defaults) and are
functions of the global step, 0-based: step s trains with ``schedule(s)``.
The trainer sets that rate on the optimizer before each step
(``set_lr``), as optax calls the schedule inside each update.

``make_optimizer`` returns ``torch.optim`` optimizers with the JAX package's
hyperparameters (optax's defaults): Adam with betas (0.9, 0.999) and eps
1e-8; AdamW with weight decay 1e-4; plain SGD; Adagrad with an initial
accumulator of 0.1 and eps 1e-7.  Adagrad differs from optax's in where eps
enters (torch adds it to the root, optax inside it).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def make_lr_schedule(base_lr: float, steps_per_epoch: int, lr_scheduler_type: str = "",
                     scheduler_params: Optional[dict] = None) -> Callable[[int], float]:
    p = dict(scheduler_params or {})
    spe = max(1, int(steps_per_epoch))

    if lr_scheduler_type == "":
        return lambda step: base_lr
    if lr_scheduler_type == "StepLR":
        step_size = int(p.get("step_size", 1))
        gamma = float(p.get("gamma", 0.1))
        return lambda step: base_lr * gamma ** ((step // spe) // step_size)
    if lr_scheduler_type == "ExponentialLR":
        gamma = float(p.get("gamma", 0.9))
        return lambda step: base_lr * gamma ** (step // spe)
    if lr_scheduler_type == "CosineAnnealingLR":
        t_max = int(p.get("T_max", 10))
        eta_min = float(p.get("eta_min", 0.0))
        return lambda step: eta_min + (base_lr - eta_min) * (
            1 + math.cos(math.pi * (step // spe) / t_max)) / 2
    raise ValueError(f"Unknown scheduler type: {lr_scheduler_type}")


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-3,
                   optimizer: str = "adam") -> torch.optim.Optimizer:
    """``lr`` is the starting rate; the trainer sets each step's with ``set_lr``."""
    name = optimizer.lower()
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
                                 weight_decay=1e-4)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if name == "adagrad":
        return torch.optim.Adagrad(params, lr=lr, initial_accumulator_value=0.1, eps=1e-7)
    raise ValueError(f"Unknown optimizer: {optimizer}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
