"""Dense table gradient of the fused lookup: ``grad[r] = sum of rows[i] with ids[i] == r``.

Replaces two TPU kernels of the JAX package
(``rec_pangu_tpu/ops/kernels/embedding_grad.py``), which compute the same
function:

* K2, ``_chunk_kernel`` (:493) behind ``presorted_segment_accumulate``: the
  planned backward, summing each vocab tile's 128-entry chunks of a host
  sort plan with one-hot matmuls, because the TPU has no fast scatter;
* K7, ``_accumulate_kernel`` (:67) behind ``sorted_segment_accumulate``: the
  backward of lookups whose ids are made on the device (ContraRec's and
  IOCRec's augmented views), which argsorts the ids on the TPU and sums
  each tile's sorted rows the same way.

The port keeps the value and drops the plan, so both are one kernel here:
the wrapper sorts the fused ids on the card (one stable ``torch.sort``,
``sort_ids``), and the CUDA kernel
(``rec_pangu_tpu_torch/csrc/embedding_grad.cu``) fills the gradient with
zeros, then sums each run of equal ids with a fixed tree of warps
(``csrc/segment_sum.cuh``: 32 sorted entries a warp, then the chunks'
partial sums, level by level) and writes the run's row once, so a warp's
work is bounded however long a run is.  ``sort_ids`` is also the
prep of the fused table Adam (``fused_adam.py``), which sums the same runs.

Bound: bytes.  At the bench shape (131,072 ids, D=32, a 1,605,632-row
table) the gradient written is 205.5 MB and the rows and ids read are
17.3 MB: 0.0665 ms at the H100 SXM's 3.35 TB/s.  At K7's call-site shape
(153,600 ids of ContraRec's three views, D=64, a 1,007,616-row table) it is
257.9 MB written and 39.9 MB read: 0.0889 ms.

Determinism: no float atomics.  The tree is fixed by the sorted ids, and the
sort is stable, so each row's sum is taken in the same order on every run
and the bits repeat.  Within a chunk of 32 sorted entries that order is
batch order, as the plain version's (``index_add_``) is on the CPU; a run
that spans chunks adds its chunks' partial sums, and ``index_add_`` on the
card uses atomics, so the two agree only to rounding (f32 sums of the same
terms in another order).

Ids outside ``[0, num_rows)`` contribute nothing, as the lookup gives them
zero rows.  The wrapper launches the kernel for CUDA tensors and raises if
it cannot; it uses the plain version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# kernel launches so far; a run resets it and reads it to show the path
# went through the kernel
LAUNCHES = 0

_FN = None


def sort_ids(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of [N] int32 fused ids -> (sorted ids, batch position of
    each sorted entry), both int32: the prep of both table kernels."""
    sorted_ids, perm = torch.sort(ids, stable=True)
    return sorted_ids, perm.to(torch.int32)


def table_grad_reference(ids: torch.Tensor, rows: torch.Tensor,
                         num_rows: int) -> torch.Tensor:
    """Plain PyTorch version: [N] ids, [N, D] rows -> [num_rows, D].  Ids
    out of range add into one spare row past the end, which is dropped (no
    shape depends on the data, so the card needs no sync)."""
    spill = torch.where((ids >= 0) & (ids < num_rows), ids, num_rows).long()
    grad = rows.new_zeros((num_rows + 1, rows.shape[1]))
    return grad.index_add_(0, spill, rows)[:num_rows]


def check_inputs(ids: torch.Tensor, rows: torch.Tensor, num_rows: int) -> None:
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be a 1-D int32 tensor, got {tuple(ids.shape)} {ids.dtype}")
    if rows.dim() != 2 or rows.dtype != torch.float32 or rows.shape[0] != ids.shape[0]:
        raise ValueError(f"rows must be float32 [{ids.shape[0]}, D], got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if rows.shape[1] < 1:
        raise ValueError("rows must have at least one column")
    if num_rows <= 0:
        raise ValueError(f"the table needs at least one row, got {num_rows}")
    if ids.device != rows.device:
        raise ValueError(f"ids and rows must share a device, got {ids.device}, {rows.device}")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no table kernel for device {ids.device}")


def _kernel():
    """(the launch, its scratch size in 4-byte words) from the library."""
    global _FN
    if _FN is None:
        from . import _build

        lib = _build.load("embedding_grad")
        fn = lib.rp_embedding_grad_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p,
                                               ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_void_p, ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        words = lib.rp_embedding_grad_workspace_words
        words.argtypes = [ctypes.c_longlong, ctypes.c_int]
        words.restype = ctypes.c_longlong
        _FN = fn, words
    return _FN


def launch(sorted_ids: torch.Tensor, perm: torch.Tensor, rows: torch.Tensor,
           num_rows: int) -> torch.Tensor:
    """The kernel alone, on ``sort_ids``' output: -> [num_rows, D]."""
    global LAUNCHES
    rows = rows.contiguous()
    dim = rows.shape[1]
    grad = torch.empty((num_rows, dim), dtype=rows.dtype, device=rows.device)
    fn, words = _kernel()
    scratch = torch.empty(words(sorted_ids.numel(), dim), dtype=torch.float32,
                          device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(sorted_ids.data_ptr(), perm.data_ptr(), rows.data_ptr(), sorted_ids.numel(),
                 grad.data_ptr(), num_rows, dim, scratch.data_ptr(), scratch.numel(),
                 stream)
    if err != 0:
        raise RuntimeError(f"embedding_grad kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return grad


def table_grad(ids: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """[N] int32 fused ids, [N, D] f32 cotangent rows -> the dense
    [num_rows, D] table gradient, zeros where no id falls."""
    check_inputs(ids, rows, num_rows)
    if ids.device.type == "cpu":
        return table_grad_reference(ids, rows, num_rows)
    sorted_ids, perm = sort_ids(ids)
    return launch(sorted_ids, perm, rows, num_rows)


def sorted_segment_accumulate(flat_ids: torch.Tensor, rows: torch.Tensor,
                              num_rows: int) -> torch.Tensor:
    """K7's counterpart under the JAX name: [N] ids of any integer type,
    [N, D] f32 rows -> the dense [num_rows, D] gradient, the ids sorted on
    the device (``table_grad``)."""
    return table_grad(flat_ids.to(torch.int32), rows, num_rows)
