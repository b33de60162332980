"""Carry weights between the JAX package's variables and the port's modules.

The JAX package's variables are ``{"params": ..., "batch_stats": ...}``,
nested dicts keyed by flax module names.  Each port model lists its weights
under those names (``jax_leaves``), so the mapping is explicit:

* flax ``Dense`` kernels are ``[in, out]``; torch ``Linear.weight`` is
  ``[out, in]``: transposed (every axis reversed, ``arr.T``).  Reversing
  fits a 1-D conv kernel too (``[k, in, out]`` -> torch's ``[out, in,
  k]``), but not a 2-D one: ``[kh, kw, in, out]`` would become ``[out, in,
  kw, kh]``.  A leaf of more than three axes therefore keeps flax's layout
  (the port's conv kernels do), and one marked transposed raises.
* the fused embedding table is copied as it is, pad rows included.
* BatchNorm ``scale``/``bias``/``mean``/``var`` map to
  ``weight``/``bias``/``running_mean``/``running_var``; LayerNorm
  ``scale``/``bias`` to ``weight``/``bias``.

A missing, extra or wrongly shaped leaf raises ``ValueError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats")


def _flatten(tree: Any, prefix: tuple) -> Dict[tuple, Any]:
    if isinstance(tree, dict):
        out: Dict[tuple, Any] = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _leaves(model):
    """``model.jax_leaves()``, refusing a transposed leaf of more than three
    axes (reversing them is no torch layout)."""
    leaves = model.jax_leaves()
    for _, path, tensor, transposed in leaves:
        if transposed and tensor.dim() > 3:
            raise ValueError(f"{'/'.join(path)}: a {tensor.dim()}-D leaf cannot be transposed "
                             f"by reversing its axes; keep it in flax's layout")
    return leaves


def _expected(model) -> Dict[tuple, tuple]:
    return {(coll,) + path: (tensor, transposed)
            for coll, path, tensor, transposed in _leaves(model)}


def load_jax_variables(model, variables: Dict[str, Any]) -> None:
    """Copy the JAX package's ``variables`` (numpy leaves) into ``model``."""
    unknown = set(variables) - set(COLLECTIONS)
    if unknown:
        raise ValueError(f"unknown variable collections {sorted(unknown)}; "
                         f"expected a subset of {COLLECTIONS}")
    got: Dict[tuple, Any] = {}
    for coll in COLLECTIONS:
        if variables.get(coll) is not None:
            got.update(_flatten(variables[coll], (coll,)))
    want = _expected(model)
    missing = sorted("/".join(k) for k in want.keys() - got.keys())
    extra = sorted("/".join(k) for k in got.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"variables do not match {type(model).__name__}: "
                         f"missing {missing}, extra {extra}")
    staged = {}
    for key, (tensor, transposed) in want.items():
        arr = np.asarray(got[key])
        if transposed:
            arr = arr.T
        if arr.shape != tuple(tensor.shape):
            raise ValueError(f"{'/'.join(key)}: shape {np.asarray(got[key]).shape} "
                             f"does not fit {tuple(tensor.shape)}"
                             f"{' (transposed)' if transposed else ''}")
        staged[key] = arr
    with torch.no_grad():  # copy only after every leaf has been checked
        for key, (tensor, _) in want.items():
            tensor.copy_(torch.from_numpy(np.array(staged[key])))


def jax_tree(model, value_of: Callable[[torch.Tensor], Optional[torch.Tensor]] = None,
             collection: str = "params") -> Optional[Dict[str, Any]]:
    """A nested numpy tree in the JAX package's layout of ``value_of(weight)``
    for each weight of ``collection`` (the weight itself by default; a
    weight whose value is None is left out), transposed as the weight is.
    None when no weight has a value."""
    tree: Dict[str, Any] = {}
    for coll, path, tensor, transposed in _leaves(model):
        value = tensor if value_of is None else value_of(tensor)
        if coll != collection or value is None:
            continue
        arr = value.detach().cpu().numpy()
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        # a copy: on the CPU .numpy() shares the live weight's memory
        node[path[-1]] = np.array(arr.T if transposed else arr, order="C")
    return tree or None


def prefixed(prefix: str, leaves):
    """``leaves`` (a module's ``jax_leaves()``) under the flax module name
    ``prefix``."""
    return [(c, (prefix,) + p, t, tr) for c, p, t, tr in leaves]


def jax_path(model, weight: torch.Tensor) -> str:
    """The ``/``-joined flax path of one of the model's weights."""
    for _, path, tensor, _ in model.jax_leaves():
        if tensor is weight:
            return "/".join(path)
    raise ValueError(f"{type(model).__name__} lists no such weight")


def jax_variables(model) -> Dict[str, Any]:
    """The model's weights as the JAX package's nested numpy variables
    (``batch_stats`` is None when the model has none)."""
    return {"params": jax_tree(model) or {},
            "batch_stats": jax_tree(model, collection="batch_stats")}
