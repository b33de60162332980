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
``load_opt_state`` loads one back (``ckpt.read_opt_state`` reads either
package's): every stepped parameter's moments into ``torch.optim.Adam``
with Adam's per-parameter ``step`` set to the checkpoint's, which sets its
bias correction.  Both steps read the table's moments from the layout's
``tables`` entry or from ``params``, so a checkpoint of either step (or of
either package's) resumes on either, exactly.

``frozen`` rows (a trainer's ``set_pretrained_weights(trainable=False)``)
keep their values through every step: Adam's update of them is undone,
as the JAX package's ``freeze_rows_transform`` zeroes it; their moments
move as Adam moves them.

A step given a ``generator`` (the sequence trainer's, seeded by ``fit``'s
``seed``) draws one dropout seed from it each step and passes it to the
model's forward (``seed=``), as the JAX step folds the step into its key.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import jax_tree
from ..ops.dropout import RowSeed, draw_seed
from ..parallel.comm import all_reduce_grads
from .ckpt import OPT_STATE_LAYOUT
from .optim import make_lr_schedule, make_optimizer, set_lr


def draw_step_seed(generator: Optional[torch.Generator], mesh_state=None,
                   global_rows: bool = True) -> int:
    """A step's dropout seed from ``generator``; while a mesh step runs a
    block of a batch split over ``data``, a ``RowSeed`` that hashes the
    block's samples as their global rows (``global_rows``: the model's
    dropout is over the batch's rows; NGCF's is over the graph's nodes,
    which every rank holds whole)."""
    seed = draw_seed(generator)
    if global_rows and mesh_state is not None and mesh_state.split:
        return RowSeed(seed, mesh_state.first_row, mesh_state.batch_rows)
    return seed


def strip_host_keys(batch: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Split off host-only entries (e.g. the 'user' id strings)."""
    device_batch = {k: v for k, v in batch.items() if v.dtype != object}
    host = {k: v for k, v in batch.items() if v.dtype == object}
    return device_batch, host


def adam_moments(model, optimizer: Optional[torch.optim.Optimizer]) -> Dict[str, Any]:
    """The first and second moments of every parameter ``optimizer`` has
    stepped, as flax-layout trees (``mu``, ``nu``), like optax's
    ``ScaleByAdamState``; None trees when ``optimizer`` is None."""
    state = {} if optimizer is None else optimizer.state

    def moment(key: str) -> Callable:
        return lambda p: state.get(p, {}).get(key)

    return {"mu": jax_tree(model, moment("exp_avg")),
            "nu": jax_tree(model, moment("exp_avg_sq"))}


def table_moments(entry: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``tables`` entry of the layout as CPU tensors in its stored dtype
    (bfloat16 from its bits)."""
    def tensor(arr):
        arr = np.asarray(arr)
        if entry.get("dtype") == "bfloat16":
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(arr, dtype=np.float32))

    return tensor(entry["mu"]), tensor(entry["nu"])


def adam_entries(model, state: Dict[str, Any]) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """{id(weight): (mu, nu)} of the layout ``state`` for each of the
    model's parameters it holds moments for, as CPU tensors in the weight's
    layout: from ``params`` (transposed back as the weight is), else from
    ``tables`` (a table's, in its stored dtype)."""
    trees = state.get("params") or {}
    tables = state.get("tables") or {}
    out = {}
    for coll, path, tensor, transposed in model.jax_leaves():
        if coll != "params":
            continue
        pair = []
        for key in ("mu", "nu"):
            node = trees.get(key)
            for name in path:
                node = node.get(name) if isinstance(node, dict) else None
            pair.append(node)
        if all(x is not None for x in pair):
            moments = tuple(torch.from_numpy(np.array(x.T if transposed else x, np.float32))
                            for x in pair)
        elif "/".join(path) in tables:
            moments = table_moments(tables["/".join(path)])
        else:
            continue
        for m in moments:
            if tuple(m.shape) != tuple(tensor.shape):
                raise ValueError(f"{'/'.join(path)}: moments of shape {tuple(m.shape)} do "
                                 f"not fit the weight's {tuple(tensor.shape)}")
        out[id(tensor)] = moments
    return out


def load_adam_state(optimizer: Optional[torch.optim.Optimizer], entries, step: int) -> None:
    """Set ``optimizer``'s (Adam's) state of each of its parameters that
    ``entries`` (``adam_entries``) holds: its moments, in float32, and its
    per-parameter ``step``."""
    if optimizer is None:
        return
    sd = optimizer.state_dict()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    sd["state"] = {i: {"step": torch.tensor(float(step), dtype=torch.float32),
                       "exp_avg": entries[id(p)][0].float(),
                       "exp_avg_sq": entries[id(p)][1].float()}
                   for i, p in enumerate(params) if id(p) in entries}
    optimizer.load_state_dict(sd)


def make_param_renorm(model, paths) -> Callable[[], None]:
    """The projection of the model's weights at the flax ``paths`` (its
    ``renorm_param_paths``): every row divided by its norm (at least 1e-12)
    in place, so zero rows stay zero, as the JAX package's
    ``make_param_renorm`` maps its params.  Adam's moments are not touched."""
    by_path = {path: tensor for _, path, tensor, _ in model.jax_leaves()}
    missing = [p for p in map(tuple, paths) if p not in by_path]
    if missing:
        raise ValueError(f"{type(model).__name__} has no weights at {missing}")
    weights = [by_path[tuple(p)] for p in paths]

    @torch.no_grad()
    def renorm() -> None:
        for w in weights:
            w.div_(torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp_min_(1e-12))

    return renorm


class StandardStep:
    """forward, ``loss.backward()``, one Adam step over every parameter;
    the ``frozen`` (weight, rows) pairs put back after it.

    On a model under a mesh (``model.mesh_state``, ``parallel/sharding``),
    a step on a block of a batch split over ``data`` all-reduces every
    gradient over ``data`` and divides it by the axis' size before Adam:
    the gradient of the global batch's mean loss (a row-sharded table's
    gradient is its block's, from the lookup's identity backward over
    ``model``).  A batch every rank runs whole exchanges nothing.
    ``global_rows`` as ``draw_step_seed``'s."""

    fused = False

    def __init__(self, model, lr: float, steps_per_epoch: int, lr_scheduler_type: str = "",
                 scheduler_params=None, generator: Optional[torch.Generator] = None,
                 frozen: Sequence[Tuple[torch.Tensor, slice]] = (), global_rows: bool = True):
        self.model = model
        self.schedule = make_lr_schedule(lr, steps_per_epoch, lr_scheduler_type,
                                         scheduler_params)
        self.optimizer = make_optimizer(model.parameters(), lr)
        self.generator = generator
        self.frozen = list(frozen)
        self.mesh_state = getattr(model, "mesh_state", None)
        self.global_rows = global_rows

    def __call__(self, inputs: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        set_lr(self.optimizer, self.schedule(step))
        self.optimizer.zero_grad(set_to_none=True)
        state = self.mesh_state
        if self.generator is None:
            out = self.model(inputs, train=True)
        else:
            out = self.model(inputs, train=True, seed=draw_step_seed(
                self.generator, state, self.global_rows))
        out["loss"].backward()
        if state is not None and state.split:
            all_reduce_grads([p.grad for p in self.model.parameters()], state.data_group)
        kept = [w.detach()[rows].clone() for w, rows in self.frozen]
        self.optimizer.step()
        with torch.no_grad():
            for (w, rows), values in zip(self.frozen, kept):
                w[rows] = values
        return out

    def load_opt_state(self, state: Dict[str, Any]) -> None:
        """Adam's state from the layout ``state`` (see the module's docstring)."""
        load_adam_state(self.optimizer, adam_entries(self.model, state), state["step"])

    def opt_state(self, step: int) -> Dict[str, Any]:
        return {"layout": OPT_STATE_LAYOUT, "step": int(step),
                "params": adam_moments(self.model, self.optimizer), "tables": {}}
