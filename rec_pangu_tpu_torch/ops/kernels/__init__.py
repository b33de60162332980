"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

Importing this package builds nothing: a kernel is built with nvcc at its
first launch (see ``_build``).
"""
from .embedding_lookup import (fused_embedding_lookup,
                               fused_embedding_lookup_reference)

__all__ = ["fused_embedding_lookup", "fused_embedding_lookup_reference"]
