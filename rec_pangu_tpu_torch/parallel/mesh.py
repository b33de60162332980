"""Device mesh for scale-out, the JAX package's ``parallel/mesh.py`` on
``torch.distributed``.

Axes: ``data`` (each rank trains on a contiguous row block of every batch)
x ``model`` (the embedding tables row-sharded).  The JAX package drives
every device of its mesh from one controller process; the port runs one
process per device, and every rank calls the same entry points (``fit``,
``evaluate_model``, the scorers) on the same global batches.

Starting the ranks, one process a device::

    # each process, rank r of n, e.g. from torchrun or torch.multiprocessing
    from rec_pangu_tpu_torch.parallel import initialize_multihost, make_mesh

    device = initialize_multihost("10.0.0.1:29500", n, r)  # NCCL, cuda:<local rank>
    mesh = make_mesh(n_data=n, n_model=1)                  # or (n // 2, 2)
    RankTrainer(device=device).fit(model, loader, mesh=mesh)

``initialize_multihost`` takes NCCL and the card by default and raises
without CUDA; ``device="cpu"`` joins over gloo instead (the tests).  Pair
it with the loader's ``shard_rank=<data rank>, num_shards=<n_data>`` for
per-host input: ``fit`` then takes each batch as the rank's own block.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

# The JAX package's trace-time mesh.  Kept for the API: the port's modules
# read their mesh from what ``sharding.shard_state`` sets on them.
_ACTIVE_MESH = None


def set_active_mesh(mesh):
    """Install ``mesh`` as the active mesh; returns the previous one."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    return prev


def active_mesh():
    return _ACTIVE_MESH


def _init_method(address: Optional[str]) -> str:
    if address is None:
        return "env://"
    if "://" in address:
        return address
    return f"tcp://{address}"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: DeviceLike = None,
                         backend: Optional[str] = None) -> torch.device:
    """Join this process to the world group: call once a process, before
    ``make_mesh``.  ``coordinator_address`` is ``host:port`` (a TCP
    rendezvous at rank 0's host) or an init URL (``tcp://``, ``file://``);
    None reads ``MASTER_ADDR``/``MASTER_PORT`` (``env://``, as torchrun
    sets them), and ``num_processes``/``process_id`` then default to
    ``WORLD_SIZE``/``RANK``.  ``device`` None means the card: NCCL, and the
    process takes ``cuda:<LOCAL_RANK or rank, modulo the cards>``; it
    raises without CUDA.  ``device="cpu"`` joins over gloo.  ``backend``
    overrides the backend (gloo with CUDA tensors, where NCCL cannot run
    two ranks on one card).  Returns the rank's device."""
    dev = resolve_device(device)
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", process_id))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=int(num_processes), rank=int(process_id))
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device: DeviceLike = None):
    """A ``torch.distributed`` ``DeviceMesh`` of shape ``(n_data, n_model)``
    named ``("data", "model")`` over the world group (rank ``d * n_model +
    m`` at coordinate (d, m)); ``n_data`` None takes the world over
    ``n_model``.  ``device`` None means the card (raises without CUDA),
    ``"cpu"`` a CPU mesh.  Raises if the world is not ``n_data * n_model``
    ranks or no process group was initialized."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost on every rank first")
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n_model = int(n_model)
    if n_data is None:
        n_data = world // max(n_model, 1)
    n_data = int(n_data)
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks, "
                         f"the world has {world}")
    return init_device_mesh(dev.type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_shape(mesh) -> tuple:
    """(n_data, n_model) of a mesh from ``make_mesh``."""
    return (mesh.size(0), mesh.size(1))
