"""Sharding policy: which weight goes where on the mesh, and the rank's
share of a batch, as the JAX package's ``parallel/sharding.py``.

Policy (``state_shardings``): the table of a ``FusedEmbedding`` or an
``ItemEmbedding`` (a 2-D weight at a flax path ending in ``table``: the
ranking models' fused table, the sequence models' item tables) whose rows
divide the ``model`` axis is row-sharded over it; every other weight and
optimizer moment is replicated; batches are split over ``data`` on their
leading axis.

``shard_state(model, mesh)`` applies the policy in place, on every rank:
each sharded table keeps the rank's ``[V / n_model, D]`` block of rows
(``row_shard`` = (first row, whole rows) on the module, its lookup on ids
shifted by the first row), and every module whose forward reads the mesh
(the embeddings, the BatchNorms of ``mlp.flax_batch_norm``) gets the
returned ``MeshState`` as ``mesh_state``; the model gets it too (the
sequence models' losses read it: the row-sharded softmax CE, the loss
terms over the whole batch).  Moments
follow their weights: an optimizer built after ``shard_state`` holds the
block's.  ``whole_variables`` and ``whole_opt_state`` gather the sharded
tables back over ``model`` (the checkpoint writers: a checkpoint holds the
whole tables in the JAX layout, whatever the mesh); ``shard_variables``
and ``shard_opt_state`` cut a whole checkpoint to the rank's blocks (the
readers).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..convert import jax_variables
from ..ops.embedding import FusedEmbedding, ItemEmbedding
from .comm import gather_rows
from .mesh import DATA_AXIS, MODEL_AXIS, mesh_shape

ROWS, REPLICATED = "rows", "replicated"


class MeshState:
    """The mesh as a sharded model's modules read it, and the batch a step
    or an evaluation runs now: ``split`` True while each ``data`` rank runs
    its own block of the batch (False for a batch every rank runs whole),
    ``first_row`` that block's first row in the global batch (the dropout
    hash's sample index, ``ops/dropout.RowSeed``) and ``batch_rows`` the
    global batch's rows."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_data, self.n_model = mesh_shape(mesh)
        self.data_rank = mesh.get_local_rank(DATA_AXIS)
        self.model_rank = mesh.get_local_rank(MODEL_AXIS)
        self.data_group = mesh.get_group(DATA_AXIS)
        self.model_group = mesh.get_group(MODEL_AXIS)
        self.split = False
        self.first_row = 0
        self.batch_rows = 0
        self.tables: List[Tuple[str, nn.Module]] = []  # (flax path, embedding) sharded

    @property
    def is_writer(self) -> bool:
        """Global rank 0: the one rank that writes checkpoints and logs."""
        return dist.get_rank() == 0

    def splits(self, rows: int) -> bool:
        """Whether a batch of ``rows`` rows is split over ``data`` (else
        every rank runs it whole, as the JAX package places a batch that
        does not divide the axis replicated)."""
        return self.n_data > 1 and rows % self.n_data == 0

    @contextlib.contextmanager
    def running(self, split: bool, first_row: int = 0, batch_rows: int = 0):
        """The modules read ``split``, ``first_row`` and ``batch_rows``
        inside."""
        prev = (self.split, self.first_row, self.batch_rows)
        self.split, self.first_row, self.batch_rows = bool(split), int(first_row), int(batch_rows)
        try:
            yield self
        finally:
            self.split, self.first_row, self.batch_rows = prev


_EMBEDDINGS = (FusedEmbedding, ItemEmbedding)


def _sharded_table(module: nn.Module, n_model: int) -> bool:
    return (isinstance(module, _EMBEDDINGS) and n_model > 1
            and module.table.shape[0] % n_model == 0)


def state_shardings(model, mesh) -> Dict[str, str]:
    """{flax path: ``"rows"`` or ``"replicated"``} of every weight of
    ``model`` under ``mesh`` (the policy above)."""
    n_model = mesh_shape(mesh)[1]
    rows = {id(m.table) for m in model.modules() if _sharded_table(m, n_model)}
    return {"/".join(path): ROWS if id(t) in rows else REPLICATED
            for _, path, t, _ in model.jax_leaves()}


def shard_state(model, mesh) -> MeshState:
    """Apply the policy to ``model`` in place (see the module's docstring);
    returns the ``MeshState`` its modules now read.  Call it on every rank,
    before any optimizer is built over the model."""
    state = MeshState(mesh)
    paths = {id(t): "/".join(p) for _, p, t, _ in model.jax_leaves()}
    for module in model.modules():
        if _sharded_table(module, state.n_model):
            whole = module.table.shape[0]
            rows = whole // state.n_model
            first = state.model_rank * rows
            path = paths[id(module.table)]
            module.table = nn.Parameter(module.table.detach()[first:first + rows].clone())
            module.row_shard = (first, whole)
            module.register_buffer("shard_offsets",
                                   (module.offsets.long() - first).to(torch.int32),
                                   persistent=False)
            state.tables.append((path, module))
        if isinstance(module, _EMBEDDINGS + (nn.BatchNorm1d,)):
            module.mesh_state = state
    model.mesh_state = state
    return state


def batch_shardings(batch: Dict[str, Any], mesh) -> Dict[str, str]:
    """{key: ``"data"``}: every batch array is split over ``data`` on its
    leading axis."""
    return {k: DATA_AXIS for k in batch}


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The rank's contiguous row block of a host batch split over ``data``
    (the JAX package's ``P("data")`` placement); raises when the batch does
    not divide the axis."""
    n_data = mesh_shape(mesh)[0]
    r = mesh.get_local_rank(DATA_AXIS)
    n = len(next(iter(batch.values())))
    if n % n_data:
        raise ValueError(f"a batch of {n} rows does not split over {n_data} data ranks")
    b = n // n_data
    return {k: v[r * b:(r + 1) * b] for k, v in batch.items()}


def _node(tree: Optional[dict], path: str):
    for name in path.split("/"):
        tree = tree.get(name) if isinstance(tree, dict) else None
    return tree


def _set(tree: dict, path: str, value) -> None:
    names = path.split("/")
    for name in names[:-1]:
        tree = tree[name]
    tree[names[-1]] = value


def _whole(state: MeshState, arr: np.ndarray, device: torch.device) -> np.ndarray:
    """A row block gathered over ``model`` into the whole table (a
    collective: every rank calls it)."""
    bits = arr.view(np.int16) if arr.dtype == np.uint16 else arr  # bfloat16 moments' bits
    t = torch.from_numpy(np.ascontiguousarray(bits)).to(device)
    return gather_rows(t, state.model_group).cpu().numpy().view(arr.dtype)


def _block(state: MeshState, module: nn.Module, arr) -> np.ndarray:
    first, whole = module.row_shard
    arr = np.asarray(arr)
    if arr.shape[0] != whole:
        raise ValueError(f"a table of {arr.shape[0]} rows does not fit the sharded table's "
                         f"{whole}")
    return arr[first:first + whole // state.n_model]


def _map_tables(model, tree: Optional[dict], fn) -> Optional[dict]:
    """``tree`` (a flax-layout dict) with each sharded table's leaf mapped
    by ``fn(state, module, leaf)``; the same tree when nothing is sharded."""
    state = getattr(model, "mesh_state", None)
    if tree is None or state is None or not state.tables:
        return tree
    out = _copy(tree)
    for path, module in state.tables:
        leaf = _node(out, path)
        if leaf is not None:
            _set(out, path, fn(state, module, leaf))
    return out


def _copy(tree):
    return {k: _copy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def whole_variables(model) -> Dict[str, Any]:
    """``jax_variables(model)`` with every sharded table gathered whole (a
    collective on a sharded model: every rank calls it)."""
    variables = jax_variables(model)
    gather = lambda s, m, leaf: _whole(s, leaf, m.table.device)  # noqa: E731
    return {"params": _map_tables(model, variables["params"], gather),
            "batch_stats": variables["batch_stats"]}


def shard_variables(model, variables: Dict[str, Any]) -> Dict[str, Any]:
    """A checkpoint's whole ``variables`` cut to the rank's table blocks."""
    return {**variables, "params": _map_tables(model, variables.get("params"), _block)}


def _map_opt_state(model, state: Optional[Dict[str, Any]], fn) -> Optional[Dict[str, Any]]:
    """The layout's optimizer state (``train/ckpt.py``) with each sharded
    table's moments mapped: under ``params`` (the standard step's) and
    under ``tables`` (the fused step's entry, keyed by the flax path)."""
    mesh_state = getattr(model, "mesh_state", None)
    if state is None or mesh_state is None or not mesh_state.tables:
        return state
    params = state.get("params") or {}
    out = {**state, "params": {k: _map_tables(model, params.get(k), fn)
                               for k in ("mu", "nu")}}
    tables = dict(state.get("tables") or {})
    for path, module in mesh_state.tables:
        if path in tables:
            entry = tables[path]
            tables[path] = {**entry, "mu": fn(mesh_state, module, entry["mu"]),
                            "nu": fn(mesh_state, module, entry["nu"])}
    out["tables"] = tables
    return out


def whole_opt_state(model, state: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The optimizer state with every sharded table's moments gathered
    whole (a collective on a sharded model)."""
    return _map_opt_state(model, state,
                          lambda s, m, leaf: _whole(s, np.asarray(leaf), m.table.device))


def shard_opt_state(model, state: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """A checkpoint's optimizer state cut to the rank's table blocks."""
    return _map_opt_state(model, state, _block)


def shard_frozen(model, frozen: List[Tuple[torch.Tensor, slice]], whole_tables: Dict[int, str]
                 ) -> List[Tuple[torch.Tensor, slice]]:
    """Frozen (table, rows) pairs written on the whole tables (``id(table)``
    -> its flax path in ``whole_tables``, taken before ``shard_state``) as
    pairs on the rank's blocks: each slice cut to the block, shifted to its
    first row; a pair outside the block is dropped."""
    state = getattr(model, "mesh_state", None)
    if state is None or not state.tables:
        return frozen
    by_path = dict(state.tables)
    out = []
    for table, rows in frozen:
        module = by_path.get(whole_tables.get(id(table)))
        if module is None:
            out.append((table, rows))
            continue
        first, whole = module.row_shard
        end = first + whole // state.n_model
        lo, hi = max(rows.start, first), min(rows.stop, end)
        if lo < hi:
            out.append((module.table, slice(lo - first, hi - first)))
    return out
