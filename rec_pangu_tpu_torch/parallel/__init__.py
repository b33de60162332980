"""Scale-out on ``torch.distributed``: the mesh, the sharding policy, the
collectives of the mesh paths and the distributed top-k (the JAX
package's ``parallel`` package, one process per device)."""
from .mesh import (DATA_AXIS, MODEL_AXIS, active_mesh, initialize_multihost, make_mesh,
                   set_active_mesh)
from .sharding import MeshState, batch_shardings, shard_batch, shard_state, state_shardings
from .topk import distributed_masked_topk, distributed_topk, pad_to_multiple

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "initialize_multihost",
    "active_mesh",
    "set_active_mesh",
    "MeshState",
    "batch_shardings",
    "shard_batch",
    "shard_state",
    "state_shardings",
    "distributed_topk",
    "distributed_masked_topk",
    "pad_to_multiple",
]
