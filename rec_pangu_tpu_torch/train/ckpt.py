"""Checkpoints in the JAX package's layout.

A checkpoint is one pickle of ``{params, batch_stats, opt_state, enc_dict,
config, step}`` with numpy leaves, keyed by flax module names.  One written
by the JAX trainer pickles optax's state classes in ``opt_state``; a plain
``pickle.load`` would import optax and jax to rebuild them.  The reader here
turns every class from ``jax``, ``jaxlib``, ``flax``, ``optax`` or
``rec_pangu_tpu`` into an inert placeholder instead: serving needs only
``params``, ``batch_stats`` and ``enc_dict``.

Unpickling runs code named in the file: load only checkpoints this program
or the JAX package wrote.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

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
