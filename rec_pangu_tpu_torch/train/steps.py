"""The standard train step, and what every train step shares.

A step takes a batch already on the device (``RankModelBase.upload_batch``
with ``train=True``) and the 0-based global step, runs forward, backward and
the optimizer, and returns the model's outputs (``pred``, ``loss``).  The
standard step (the JAX package's ``steps._train_step_fn``) differentiates
every parameter, the table included: on the card the table's gradient is the
dense ``[rows, D]`` gradient from the lookup's backward kernel (K2), and the
optimizer then runs over all parameters.  The fused step
(``fused_update.py``) is the default for Adam.

``opt_state`` writes the optimizer's state for a checkpoint in the port's
layout (``ckpt.py``); the JAX package's optax state is not written.

A step given a ``generator`` (the sequence trainer's, seeded by ``fit``'s
``seed``) draws one dropout seed from it each step and passes it to the
model's forward (``seed=``), as the JAX step folds the step into its key.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..convert import jax_tree
from ..ops.sequence_enc import draw_seed
from .optim import make_lr_schedule, make_optimizer, set_lr

OPT_STATE_LAYOUT = "rec_pangu_tpu_torch/adam-1"


def strip_host_keys(batch: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Split off host-only entries (e.g. the 'user' id strings)."""
    device_batch = {k: v for k, v in batch.items() if v.dtype != object}
    host = {k: v for k, v in batch.items() if v.dtype == object}
    return device_batch, host


def adam_moments(model, optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The first and second moments of every parameter ``optimizer`` has
    stepped, as flax-layout trees (``mu``, ``nu``), like optax's
    ``ScaleByAdamState``."""
    def moment(key: str) -> Callable:
        return lambda p: optimizer.state.get(p, {}).get(key)

    return {"mu": jax_tree(model, moment("exp_avg")),
            "nu": jax_tree(model, moment("exp_avg_sq"))}


class StandardStep:
    """forward, ``loss.backward()``, one Adam step over every parameter."""

    fused = False

    def __init__(self, model, lr: float, steps_per_epoch: int, lr_scheduler_type: str = "",
                 scheduler_params=None, generator: Optional[torch.Generator] = None):
        self.model = model
        self.schedule = make_lr_schedule(lr, steps_per_epoch, lr_scheduler_type,
                                         scheduler_params)
        self.optimizer = make_optimizer(model.parameters(), lr)
        self.generator = generator

    def __call__(self, inputs: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        set_lr(self.optimizer, self.schedule(step))
        self.optimizer.zero_grad(set_to_none=True)
        if self.generator is None:
            out = self.model(inputs, train=True)
        else:
            out = self.model(inputs, train=True, seed=draw_seed(self.generator))
        out["loss"].backward()
        self.optimizer.step()
        return out

    def opt_state(self, step: int) -> Dict[str, Any]:
        return {"layout": OPT_STATE_LAYOUT, "step": int(step),
                "params": adam_moments(self.model, self.optimizer), "tables": {}}
