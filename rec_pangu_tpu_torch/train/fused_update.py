"""Train step with the table's Adam update fused into the table kernel.

The standard step (``steps.StandardStep``) writes a dense ``[rows, D]``
table gradient and then runs Adam over the whole table: eight table passes
per step.  This step, the JAX package's ``train/fused_update.py``:

1. runs the model with the table held out of autograd (``FusedEmbedding``'s
   capture mode): the gathered rows are a leaf, and their gradient is
   d(loss)/d(rows) ``[N, D]``, so no dense table gradient ever exists;
2. updates every other parameter with ``torch.optim.Adam`` (optax's
   ``masked`` Adam, the same schedule and betas);
3. updates the table and its two moments in place with one fused Adam pass
   (``ops/kernels/fused_adam.planned_adam_update``: K3 on the card), which
   applies Adam over the dense gradient, absent rows included.

The JAX package also gates the step on TPU performance (a table and a batch
large enough for its planned kernels); those gates do not carry over: the
step runs for every model with a ``FusedEmbedding``.  ``fit`` trains with
Adam from a fresh state, as the JAX package's does; resuming is not ported
yet (ROADMAP Queue 1).  ``REC_PANGU_TPU_FUSED_ADAM=0`` turns the step off,
as it does in the JAX package, and the trainer then takes the standard step.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from ..convert import jax_path
from ..ops.embedding import FusedEmbedding
from ..ops.kernels.embedding_lookup import fused_ids
from ..ops.kernels.fused_adam import adam_hyper, planned_adam_update
from .optim import ADAM_B1, ADAM_B2, ADAM_EPS, make_lr_schedule, make_optimizer, set_lr
from .steps import OPT_STATE_LAYOUT, adam_moments


class FusedStep:
    """Autograd for the dense parameters and the captured rows, Adam on the
    dense parameters, the fused Adam kernel on the table."""

    fused = True

    def __init__(self, model, lr: float, steps_per_epoch: int, lr_scheduler_type: str = "",
                 scheduler_params=None):
        self.model = model
        self.embedding: FusedEmbedding = model.embedding
        table = self.embedding.table
        self.schedule = make_lr_schedule(lr, steps_per_epoch, lr_scheduler_type,
                                         scheduler_params)
        self.dense = [p for p in model.parameters() if p is not table]
        self.optimizer = make_optimizer(self.dense, lr)
        self.mu = torch.zeros_like(table)
        self.nu = torch.zeros_like(table)

    def __call__(self, inputs: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        lr = self.schedule(step)
        set_lr(self.optimizer, lr)
        captured = []
        out = self.model(inputs, train=True, capture=captured)
        if len(captured) != 1:  # each lookup would need its own ids here
            raise ValueError(f"the fused step needs exactly one lookup of the table in "
                             f"the forward, got {len(captured)}")
        grads = torch.autograd.grad(out["loss"], self.dense + captured)
        for p, g in zip(self.dense, grads):
            p.grad = g
        self.optimizer.step()
        rows = grads[-1]
        table = self.embedding.table
        with torch.no_grad():
            planned_adam_update(fused_ids(inputs["sparse"], self.embedding.offsets),
                                rows.reshape(-1, rows.shape[-1]), table, self.mu, self.nu,
                                adam_hyper(step + 1, lr, ADAM_B1, ADAM_B2, ADAM_EPS))
        return out

    def opt_state(self, step: int) -> Dict[str, Any]:
        key = jax_path(self.model, self.embedding.table)
        return {"layout": OPT_STATE_LAYOUT, "step": int(step),
                "params": adam_moments(self.model, self.optimizer),
                "tables": {key: {"mu": self.mu.to("cpu", copy=True).numpy(),
                                 "nu": self.nu.to("cpu", copy=True).numpy()}}}


def maybe_enable_fused_update(model, lr: float, steps_per_epoch: int,
                              lr_scheduler_type: str = "",
                              scheduler_params=None) -> Optional[FusedStep]:
    """The fused Adam step for ``model`` from a fresh state, or None when it
    does not apply: the model has no ``FusedEmbedding``, or
    ``REC_PANGU_TPU_FUSED_ADAM`` is set to something other than 1/on/true."""
    if os.environ.get("REC_PANGU_TPU_FUSED_ADAM", "1") not in ("1", "on", "true"):
        return None
    if not isinstance(getattr(model, "embedding", None), FusedEmbedding):
        return None
    return FusedStep(model, lr, steps_per_epoch, lr_scheduler_type, scheduler_params)
