"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

Importing this package builds nothing: a kernel is built with nvcc at its
first launch (see ``_build``).
"""
from .embedding_grad import sort_ids, table_grad, table_grad_reference
from .embedding_lookup import (fused_embedding_lookup,
                               fused_embedding_lookup_reference)
from .fused_adam import adam_hyper, planned_adam_update, planned_adam_update_reference

__all__ = ["adam_hyper", "table_grad", "table_grad_reference",
           "fused_embedding_lookup", "fused_embedding_lookup_reference",
           "planned_adam_update", "planned_adam_update_reference", "sort_ids"]
