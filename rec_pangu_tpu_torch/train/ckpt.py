"""Checkpoints in the JAX package's layout.

A checkpoint is one pickle of ``{params, batch_stats, opt_state, enc_dict,
config, step}`` with numpy leaves, keyed by flax module names.  One written
by the JAX trainer pickles optax's state classes in ``opt_state``; a plain
``pickle.load`` would import optax and jax to rebuild them.  The reader here
turns every class from ``jax``, ``jaxlib``, ``flax``, ``optax`` or
``rec_pangu_tpu`` into an inert placeholder instead: serving needs only
``params``, ``batch_stats`` and ``enc_dict``.

A checkpoint the port's trainer writes (``save_all``, ``save_train_model``)
carries its optimizer state in the port's own layout, plain dicts of numpy
arrays that the JAX package's ``load_checkpoint`` reads as they are::

    opt_state = {
        "layout": "rec_pangu_tpu_torch/adam-1",
        "step": <steps taken>,
        # Adam moments of every parameter torch.optim.Adam steps, keyed and
        # transposed like ``params`` (the table too on the standard step)
        "params": {"mu": {...}, "nu": {...}},
        # the fused step's table moments, keyed by the table's flax path, in
        # their storage dtype: "float32" arrays, or "bfloat16"
        # (REC_PANGU_TPU_MOMENT_DTYPE=bf16) as uint16 arrays of the bf16 bits
        "tables": {"FusedEmbedding_0/table": {"mu": [rows, D], "nu": [rows, D],
                                              "dtype": "float32"}},
    }

``read_opt_state`` turns the optimizer state of either package's
checkpoint into this layout for ``fit(resume_from=...)``: the port's as it
is; the JAX trainer's from optax's ``ScaleByAdamState(count, mu, nu)``
inside its chain (the standard step's, or the fused step's masked one,
whose masked-out leaves are left out), with the fused step's table
moments beside it (``{"<flax path>": {"mu", "nu"}}``), already keyed and
laid out as here.  The JAX trainer cannot resume from a port checkpoint:
its ``resume`` wants optax's state and restores only the params.

Unpickling runs code named in the file: load only checkpoints this program
or the JAX package wrote.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

OPT_STATE_LAYOUT = "rec_pangu_tpu_torch/adam-1"
_FOREIGN_ROOTS = frozenset({"jax", "jaxlib", "flax", "optax", "rec_pangu_tpu"})


class ForeignObject:
    """Stand-in for an object of a JAX-side class; keeps what was pickled."""

    jax_class = ""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        return obj

    def __setstate__(self, state):
        self.state = state

    def __repr__(self) -> str:
        return f"ForeignObject({self.jax_class})"


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _FOREIGN_ROOTS:
            return type(name, (ForeignObject,), {"jax_class": f"{module}.{name}"})
        return super().find_class(module, name)


def moment_arrays(mu: torch.Tensor, nu: torch.Tensor) -> Dict[str, Any]:
    """A table's Adam moments as the layout's numpy entry (bfloat16 as its
    uint16 bits: numpy has no bfloat16)."""
    def host(t):
        t = t.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return {"mu": host(mu), "nu": host(nu),
            "dtype": "bfloat16" if mu.dtype == torch.bfloat16 else "float32"}


def _moment_entry(mu: np.ndarray, nu: np.ndarray) -> Dict[str, Any]:
    """A table's moments from the JAX package (numpy arrays, bfloat16 ones
    of ml_dtypes' type) as the layout's entry."""
    mu, nu = np.asarray(mu), np.asarray(nu)
    if mu.dtype.name == "bfloat16":
        return {"mu": mu.view(np.uint16), "nu": nu.view(np.uint16), "dtype": "bfloat16"}
    return {"mu": mu.astype(np.float32), "nu": nu.astype(np.float32), "dtype": "float32"}


def _strip_masked(tree: Any) -> Any:
    """A moment tree without optax's masked-out leaves (None when nothing
    is left)."""
    if isinstance(tree, dict):
        out = {k: _strip_masked(v) for k, v in tree.items()}
        out = {k: v for k, v in out.items() if v is not None}
        return out or None
    if isinstance(tree, ForeignObject) or tree is None:
        return None
    return np.asarray(tree)


def _walk(node: Any):
    """Every object of a pickled optimizer state, depth first."""
    yield node
    children = ()
    if isinstance(node, ForeignObject):
        children = node.args
    elif isinstance(node, (tuple, list)):
        children = node
    elif isinstance(node, dict):
        children = node.values()
    for child in children:
        yield from _walk(child)


def read_opt_state(opt_state: Any, step: int) -> Optional[Dict[str, Any]]:
    """The optimizer state of a checkpoint (see the module's docstring) in
    the port's layout; None when there is none or it holds no Adam state
    this reader knows."""
    if opt_state is None:
        return None
    if isinstance(opt_state, dict) and opt_state.get("layout") == OPT_STATE_LAYOUT:
        return opt_state
    adam = next((n for n in _walk(opt_state) if isinstance(n, ForeignObject)
                 and n.jax_class.endswith("ScaleByAdamState") and len(n.args) == 3), None)
    if adam is None:
        return None
    _, mu, nu = adam.args
    tables = {}
    for node in _walk(opt_state):  # the JAX fused step's table moments
        if (isinstance(node, dict) and node
                and all(isinstance(v, dict) and set(v) == {"mu", "nu"} for v in node.values())):
            tables.update({str(k): _moment_entry(v["mu"], v["nu"]) for k, v in node.items()})
    return {"layout": OPT_STATE_LAYOUT, "step": int(step),
            "params": {"mu": _strip_masked(mu), "nu": _strip_masked(nu)}, "tables": tables}


def save_checkpoint(path: str, params: Any, batch_stats: Any = None,
                    opt_state: Any = None, enc_dict: Optional[dict] = None,
                    config: Optional[dict] = None, step: int = 0) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": opt_state,
        "enc_dict": enc_dict,
        "config": config,
        "step": int(step),
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()
