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

``SeqFusedStep`` is the sequence models' counterpart (the JAX
``_seq_fused_step_fn``): the history lookup (``ItemEmbedding``'s capture
mode) and the streamed softmax CE (its captured variant) both hand their
table gradients to the step instead of the table, and one K3 launch applies
Adam with both: the history rows as the summed stream and the CE's
``[V_pad, D]`` item gradient as the dense one.  The rows' ids are
``inputs[model.fused_lookup_key]``: the histories by default, the ``[3B, L]``
``aug_all`` views for IOCRec, whose one lookup reads those.

``REC_PANGU_TPU_MOMENT_DTYPE=bf16`` stores both steps' table moments as
bfloat16 (``_moment_dtype``), as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

from ..convert import jax_path
from ..ops.embedding import FusedEmbedding, ItemEmbedding
from ..ops.kernels.embedding_lookup import fused_ids
from ..ops.kernels.fused_adam import adam_hyper, planned_adam_update
from ..ops.sequence_enc import draw_seed
from ..ops.softmax_ce import fused_ce_enabled
from .ckpt import moment_arrays
from .optim import ADAM_B1, ADAM_B2, ADAM_EPS, make_lr_schedule, make_optimizer, set_lr
from .steps import OPT_STATE_LAYOUT, adam_moments


def _moment_dtype() -> torch.dtype:
    """Storage dtype of the fused steps' table moments:
    ``REC_PANGU_TPU_MOMENT_DTYPE`` bf16 (or bfloat16) stores bfloat16, which
    cuts the Adam pass's bytes by a quarter; anything else float32.  The
    arithmetic is float32 either way."""
    v = os.environ.get("REC_PANGU_TPU_MOMENT_DTYPE", "f32").lower()
    return torch.bfloat16 if v in ("bf16", "bfloat16") else torch.float32


def _fused_adam_on() -> bool:
    return os.environ.get("REC_PANGU_TPU_FUSED_ADAM", "1") in ("1", "on", "true")


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
        self.mu = torch.zeros_like(table, dtype=_moment_dtype())
        self.nu = torch.zeros_like(table, dtype=_moment_dtype())

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
                "tables": {key: moment_arrays(self.mu, self.nu)}}


def maybe_enable_fused_update(model, lr: float, steps_per_epoch: int,
                              lr_scheduler_type: str = "",
                              scheduler_params=None) -> Optional[FusedStep]:
    """The fused Adam step for ``model`` from a fresh state, or None when it
    does not apply: the model has no ``FusedEmbedding``, or
    ``REC_PANGU_TPU_FUSED_ADAM`` is set to something other than 1/on/true."""
    if not _fused_adam_on():
        return None
    if not isinstance(getattr(model, "embedding", None), FusedEmbedding):
        return None
    return FusedStep(model, lr, steps_per_epoch, lr_scheduler_type, scheduler_params)


class SeqFusedStep:
    """The sequence fused step: autograd for the dense parameters, the
    captured history rows and the captured CE gradient; Adam on the dense
    parameters; one fused Adam launch on the item table with both streams."""

    fused = True

    def __init__(self, model, lr: float, steps_per_epoch: int, lr_scheduler_type: str = "",
                 scheduler_params=None, generator: Optional[torch.Generator] = None):
        self.model = model
        self.uses_ce = bool(getattr(model, "fused_uses_ce", True))
        table = model.item_emb.table
        self.schedule = make_lr_schedule(lr, steps_per_epoch, lr_scheduler_type,
                                         scheduler_params)
        self.dense = [p for p in model.parameters() if p is not table]
        self.optimizer = make_optimizer(self.dense, lr)
        self.generator = generator if generator is not None else torch.Generator()
        self.mu = torch.zeros_like(table, dtype=_moment_dtype())
        self.nu = torch.zeros_like(table, dtype=_moment_dtype())

    def __call__(self, inputs: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        lr = self.schedule(step)
        set_lr(self.optimizer, lr)
        capture: Dict[str, List[torch.Tensor]] = {"hist": []}
        if self.uses_ce:
            capture["ce"] = []
        out = self.model(inputs, train=True, capture=capture, seed=draw_seed(self.generator))
        if len(capture["hist"]) != 1:  # the rows' ids are the history's
            raise ValueError(f"the sequence fused step needs exactly one lookup of the item "
                             f"table in the forward, got {len(capture['hist'])}")
        grads = torch.autograd.grad(out["loss"], self.dense + capture["hist"],
                                    allow_unused=True)
        for p, g in zip(self.dense, grads):
            p.grad = g  # None for a weight the loss does not reach: Adam skips it
        self.optimizer.step()
        dense = None
        if self.uses_ce:
            if len(capture["ce"]) != 1:
                raise ValueError(f"the sequence fused step needs exactly one captured softmax "
                                 f"CE in the loss, got {len(capture['ce'])}")
            dense = capture["ce"][0]
        rows = grads[-1]
        table = self.model.item_emb.table
        ids = inputs[getattr(self.model, "fused_lookup_key", "hist_item_list")]
        with torch.no_grad():
            planned_adam_update(ids.reshape(-1).to(torch.int32),
                                rows.reshape(-1, rows.shape[-1]), table, self.mu, self.nu,
                                adam_hyper(step + 1, lr, ADAM_B1, ADAM_B2, ADAM_EPS), dense)
        return out

    def opt_state(self, step: int) -> Dict[str, Any]:
        key = jax_path(self.model, self.model.item_emb.table)
        return {"layout": OPT_STATE_LAYOUT, "step": int(step),
                "params": adam_moments(self.model, self.optimizer),
                "tables": {key: moment_arrays(self.mu, self.nu)}}


def seq_fused_applicable(model) -> bool:
    """The JAX gate's model conditions: a ``fused_update_compatible`` model
    (its only item-table reads in training are the history lookup and the
    full-softmax CE) with an ``ItemEmbedding`` and ``loss_type`` "full".  The
    JAX gate's TPU thresholds (``_FUSED_MIN_VOCAB``, ``planned_path_ok``,
    ``fused_adam_fits``) do not carry over."""
    if not getattr(model, "fused_update_compatible", False):
        return False
    if not isinstance(getattr(model, "item_emb", None), ItemEmbedding):
        return False
    return (getattr(model, "config", None) or {}).get("loss_type", "full") == "full"


def maybe_enable_seq_fused_update(model, lr: float, steps_per_epoch: int,
                                  lr_scheduler_type: str = "", scheduler_params=None,
                                  optimizer: str = "adam", step: int = 0,
                                  generator: Optional[torch.Generator] = None
                                  ) -> Optional[SeqFusedStep]:
    """The sequence fused step from a fresh state, or None when it does not
    apply: an optimizer other than Adam, a state past step 0,
    ``REC_PANGU_TPU_FUSED_ADAM`` other than 1/on/true,
    ``REC_PANGU_TPU_FUSED_CE`` 0/off/false, or a model
    ``seq_fused_applicable`` refuses."""
    if optimizer.lower() != "adam" or int(step) != 0:
        return None
    if not _fused_adam_on() or not fused_ce_enabled():
        return None
    if not seq_fused_applicable(model):
        return None
    return SeqFusedStep(model, lr, steps_per_epoch, lr_scheduler_type, scheduler_params,
                        generator)
