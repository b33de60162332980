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

The JAX trainer cannot resume from it (its ``resume`` wants optax's state
and restores only the params when the structure differs); the port cannot
resume yet either.

Unpickling runs code named in the file: load only checkpoints this program
or the JAX package wrote.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

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
