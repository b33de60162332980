"""Train step with the table's Adam update fused into the table kernel.

The standard step (``steps.StandardStep``) writes a dense ``[rows, D]``
table gradient and then runs Adam over the whole table: eight table passes
per step.  This step, the JAX package's ``train/fused_update.py``:

1. runs the model with its tables held out of autograd (``FusedEmbedding``'s
   capture mode): each table's gathered rows are a leaf, and their gradient
   is d(loss)/d(rows) ``[N, D]``, so no dense table gradient ever exists;
2. updates every other parameter with ``torch.optim.Adam`` (optax's
   ``masked`` Adam, the same schedule and betas);
3. updates each table and its two moments in place with one fused Adam pass
   (``ops/kernels/fused_adam.update_sorted``: K3 on the card, one launch a
   table), which applies Adam over the dense gradient, absent rows
   included.  A model may have several tables (WDL's and the other LR
   models' ``[V, 1]`` ``LRLayer`` table beside the ``[V, D]`` one, AFN's
   two), each with its own moments, as the JAX step has.  Every table
   takes the batch's fused ids, so they are sorted once a step for each
   table height (``fused_adam.sort_for``), not once a table.

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
``aug_all`` views for IOCRec and ContraRec, the ``[B, L + 1]`` ``lookup_all``
(histories and targets) for CLRec, whose one lookup reads those.  The step
checks the key and the captures before it changes any state.

``REC_PANGU_TPU_MOMENT_DTYPE=bf16`` stores both steps' table moments as
bfloat16 (``_moment_dtype``), as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..convert import jax_path
from ..ops.embedding import FusedEmbedding, ItemEmbedding
from ..ops.kernels.embedding_lookup import fused_ids
from ..ops.kernels.fused_adam import adam_hyper, planned_adam_update, sort_for, update_sorted
from ..ops.dropout import draw_seed
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


def fused_tables(model) -> List[Tuple[str, FusedEmbedding]]:
    """Every ``FusedEmbedding`` of ``model`` in registration order, with its
    module name (WDL's ``lr_layer.embedding`` and ``embedding``, AFN's
    ``embedding`` and ``embedding2``).  ``FusedStep.opt_state`` keys them
    by their tables' flax paths, as the JAX ``find_fused_tables`` does."""
    return [(name, m) for name, m in model.named_modules() if isinstance(m, FusedEmbedding)]


class FusedStep:
    """Autograd for the dense parameters and each table's captured rows,
    Adam on the dense parameters, one fused Adam launch on each table, on
    one sort of the ids for each table height.

    Every table is looked up once a forward on the batch's sparse ids, so
    every table's launch takes the same fused ids; a forward that looks a
    table up other than exactly once raises ``ValueError`` before any
    weight, moment or running statistic changes.  A step given a
    ``generator`` (``fit``'s, seeded by its ``seed``) draws the step's
    dropout seed from it; otherwise from torch's default generator."""

    fused = True

    def __init__(self, model, lr: float, steps_per_epoch: int, lr_scheduler_type: str = "",
                 scheduler_params=None, generator: Optional[torch.Generator] = None):
        self.model = model
        self.tables = fused_tables(model)
        if not self.tables:
            raise ValueError(f"{type(model).__name__} has no FusedEmbedding")
        self.schedule = make_lr_schedule(lr, steps_per_epoch, lr_scheduler_type,
                                         scheduler_params)
        held = {id(m.table) for _, m in self.tables}
        self.dense = [p for p in model.parameters() if id(p) not in held]
        # None for a model whose only weights are tables (FM)
        self.optimizer = make_optimizer(self.dense, lr) if self.dense else None
        self.generator = generator
        self.moments = [(torch.zeros_like(m.table, dtype=_moment_dtype()),
                         torch.zeros_like(m.table, dtype=_moment_dtype()))
                        for _, m in self.tables]
        # running statistics the forward moves in place, restored on a refusal
        self.stats = [b for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)
                      for b in (m.running_mean, m.running_var)]

    def _forward(self, inputs: Dict[str, torch.Tensor]):
        """The forward in capture mode and each table's captured rows, in
        the order of ``self.tables``; a table looked up other than once
        raises with every running statistic as it was."""
        saved = [b.clone() for b in self.stats]
        captured: List[Tuple[FusedEmbedding, torch.Tensor]] = []
        out = self.model(inputs, train=True, capture=captured, seed=draw_seed(self.generator))
        counts = [sum(owner is m for owner, _ in captured) for _, m in self.tables]
        if any(c != 1 for c in counts):
            with torch.no_grad():
                for b, old in zip(self.stats, saved):
                    b.copy_(old)
            raise ValueError(f"the fused step needs exactly one lookup of each table in the "
                             f"forward, got {dict(zip((p for p, _ in self.tables), counts))}")
        rows = [next(r for owner, r in captured if owner is m) for _, m in self.tables]
        return out, rows

    def __call__(self, inputs: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        lr = self.schedule(step)
        out, rows = self._forward(inputs)
        grads = torch.autograd.grad(out["loss"], self.dense + rows, allow_unused=True)
        if self.optimizer is not None:
            set_lr(self.optimizer, lr)
            for p, g in zip(self.dense, grads):
                p.grad = g  # None for a weight the loss does not reach: Adam skips it
            self.optimizer.step()
        hyper = adam_hyper(step + 1, lr, ADAM_B1, ADAM_B2, ADAM_EPS)
        ids = fused_ids(inputs["sparse"], self.tables[0][1].offsets)
        sorted_ids = {}  # table height -> the ids sorted for it, once a step
        with torch.no_grad():
            for (_, emb), (mu, nu), r, g in zip(self.tables, self.moments, rows,
                                                grads[len(self.dense):]):
                g = torch.zeros_like(r) if g is None else g
                height = emb.table.shape[0]
                if height not in sorted_ids:
                    sorted_ids[height] = sort_for(ids, height)
                update_sorted(sorted_ids[height], g.reshape(-1, g.shape[-1]), emb.table, mu, nu,
                              hyper)
        return out

    def opt_state(self, step: int) -> Dict[str, Any]:
        return {"layout": OPT_STATE_LAYOUT, "step": int(step),
                "params": adam_moments(self.model, self.optimizer),
                "tables": {jax_path(self.model, m.table): moment_arrays(mu, nu)
                           for (_, m), (mu, nu) in zip(self.tables, self.moments)}}


def maybe_enable_fused_update(model, lr: float, steps_per_epoch: int,
                              lr_scheduler_type: str = "", scheduler_params=None,
                              generator: Optional[torch.Generator] = None
                              ) -> Optional[FusedStep]:
    """The fused Adam step for ``model`` from a fresh state, or None when it
    does not apply: the model has no ``FusedEmbedding``, or
    ``REC_PANGU_TPU_FUSED_ADAM`` is set to something other than 1/on/true."""
    if not _fused_adam_on():
        return None
    if not any(isinstance(m, FusedEmbedding) for m in model.modules()):
        return None
    return FusedStep(model, lr, steps_per_epoch, lr_scheduler_type, scheduler_params,
                     generator)


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
        # None for a model whose only weight is the table (YotubeDNN)
        self.optimizer = make_optimizer(self.dense, lr) if self.dense else None
        self.generator = generator if generator is not None else torch.Generator()
        self.mu = torch.zeros_like(table, dtype=_moment_dtype())
        self.nu = torch.zeros_like(table, dtype=_moment_dtype())

    def __call__(self, inputs: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        """One step; a batch without the model's ``fused_lookup_key``, or a
        forward that does not capture exactly one lookup (and one CE when
        the loss uses it), raises ``ValueError`` before any state changes."""
        key = getattr(self.model, "fused_lookup_key", "hist_item_list")
        if key not in inputs:
            raise ValueError(f"the sequence fused step reads the table rows' ids from "
                             f"inputs[{key!r}], which this batch lacks")
        lr = self.schedule(step)
        capture: Dict[str, List[torch.Tensor]] = {"hist": []}
        if self.uses_ce:
            capture["ce"] = []
        out = self.model(inputs, train=True, capture=capture, seed=draw_seed(self.generator))
        if len(capture["hist"]) != 1:  # the rows' ids are inputs[key]
            raise ValueError(f"the sequence fused step needs exactly one lookup of the item "
                             f"table in the forward, got {len(capture['hist'])}")
        grads = torch.autograd.grad(out["loss"], self.dense + capture["hist"],
                                    allow_unused=True)
        dense = None
        if self.uses_ce:  # the CE's backward has appended its gradient by now
            if len(capture["ce"]) != 1:
                raise ValueError(f"the sequence fused step needs exactly one captured softmax "
                                 f"CE in the loss, got {len(capture['ce'])}")
            dense = capture["ce"][0]
        if self.optimizer is not None:
            set_lr(self.optimizer, lr)
            for p, g in zip(self.dense, grads):
                p.grad = g  # None for a weight the loss does not reach: Adam skips it
            self.optimizer.step()
        rows = grads[-1]
        table = self.model.item_emb.table
        ids = inputs[key]
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
