"""Fused-table embedding lookup: ``table[sparse + offsets]``.

Replaces the JAX package's K1, the scan-select forward of the planned lookup
(``rec_pangu_tpu/ops/kernels/embedding_grad.py``: ``_select_tile_kernel``
and its chunk-grid twin ``_select_kernel``, launched from ``_select_stream``
behind ``planned_gather``).  K1 streams the whole table through VMEM and
selects rows with one-hot matmuls, guided by a host sort plan, because the
TPU has no fast hardware gather.  Hopper gathers natively, so the port keeps
the value and drops the layout: the CUDA kernel
(``rec_pangu_tpu_torch/csrc/embedding_lookup.cu``) reads only the rows the
batch names and needs no plan.

Bound: bytes.  At the bench shape (batch 8192 x 16 fields, D=32, f32) the
lookup reads 131,072 rows of 128 B and writes as many, plus 0.5 MB of ids:
about 34 MB, some 10 us at the H100 SXM's 3.35 TB/s.  The kernel moves each
row once with coalesced 16-byte accesses and folds the per-field offset add
in, so nothing else touches device memory.

A fused id outside ``[0, rows)`` gives a zero row, as in K1 (such an id
matches no one-hot column).  Callers that take ids from outside check them
on the host first and raise (``ops.embedding.check_ids``).

The wrapper launches the kernel for CUDA tensors and raises if it cannot;
it uses the plain version below only for tensors on the CPU.  On the card
the lookup's backward is the table gradient kernel (``embedding_grad.py``).
"""
from __future__ import annotations

import ctypes

import torch

from .embedding_grad import table_grad

# kernel launches so far; a run resets it and reads it to show the path
# went through the kernel
LAUNCHES = 0

_FN = None


def fused_embedding_lookup_reference(table: torch.Tensor, sparse: torch.Tensor,
                                     offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [R, D] table, [B, F] ids, [F] offsets -> [B, F, D]."""
    ids = sparse.long() + offsets.long()
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    return torch.where(valid.unsqueeze(-1), rows, rows.new_zeros(()))


def _check(table: torch.Tensor, sparse: torch.Tensor, offsets: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.float32 or table.shape[0] == 0:
        raise ValueError(f"table must be a non-empty 2-D float32 tensor, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if sparse.dim() != 2 or sparse.dtype != torch.int32:
        raise ValueError(f"sparse ids must be a 2-D int32 tensor, got "
                         f"{tuple(sparse.shape)} {sparse.dtype}")
    if offsets.shape != (sparse.shape[1],) or offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be int32 [{sparse.shape[1]}], got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if not (table.device == sparse.device == offsets.device):
        raise ValueError(f"table, ids and offsets must share a device, got "
                         f"{table.device}, {sparse.device}, {offsets.device}")


def _kernel():
    global _FN
    if _FN is None:
        from . import _build

        fn = _build.load("embedding_lookup").rp_embedding_lookup_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(table: torch.Tensor, sparse: torch.Tensor,
            offsets: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if not (table.is_contiguous() and sparse.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("the lookup kernel takes contiguous table, ids and offsets")
    b, f = sparse.shape
    out = torch.empty((b, f, table.shape[1]), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), sparse.data_ptr(), offsets.data_ptr(),
                 out.data_ptr(), table.shape[0], b * f, f, table.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"embedding_lookup kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def fused_ids(sparse: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """[B, F] per-field ids + [F] offsets -> the [B*F] int32 fused ids."""
    return (sparse + offsets).reshape(-1)


class _KernelLookup(torch.autograd.Function):
    """The lookup kernel forward; the table gradient kernel (K2,
    ``embedding_grad.py``) backward."""

    @staticmethod
    def forward(ctx, table, sparse, offsets):
        ctx.save_for_backward(sparse, offsets)
        ctx.num_rows = table.shape[0]
        return _launch(table, sparse, offsets)

    @staticmethod
    def backward(ctx, grad):
        sparse, offsets = ctx.saved_tensors
        rows = grad.reshape(-1, grad.shape[-1])
        return (table_grad(fused_ids(sparse, offsets), rows, ctx.num_rows),
                None, None)


def fused_embedding_lookup(table: torch.Tensor, sparse: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """[R, D] f32 table, [B, F] i32 per-field ids, [F] i32 row offsets
    -> [B, F, D] = ``table[sparse + offsets]``, zero rows for ids out of range."""
    _check(table, sparse, offsets)
    if table.device.type == "cpu":
        return fused_embedding_lookup_reference(table, sparse, offsets)
    if table.device.type != "cuda":
        raise ValueError(f"no embedding lookup kernel for device {table.device}")
    return _KernelLookup.apply(table, sparse, offsets)
