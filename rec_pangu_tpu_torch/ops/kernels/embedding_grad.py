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

The port keeps the value and drops the plan, so both are one kernel here
(``rec_pangu_tpu_torch/csrc/embedding_grad.cu``).  The wrapper sorts the
fused ids on the card with the package's own stable radix sort
(``sort_ids``, ``csrc/radix_sort.cuh``: keys ``clamp(id, -1, num_rows) + 1``
over only the bits a table of ``num_rows`` needs, 3 passes of 7 bits at
the bench shape), whose first launch also marks the rows the batch
touches.  Then it forks: a second stream zeroes the unmarked rows while the
caller's stream runs the sort's passes and the levels of
``csrc/segment_sum.cuh`` (a fixed tree of warps: 32 sorted entries a warp,
then the chunks' partial sums, level by level, all in one launch), which
write each touched row once.  The wrapper joins the streams before it returns, so the caller
sees one stream's work, under ``torch.cuda.graph`` capture too.
``sort_ids`` is also the prep of the fused table Adam (``fused_adam.py``),
which sums the same runs.

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
terms in another order).  Clamping the keys moves no in-range id: every id
below 0 still sorts before them and every id at or past ``num_rows`` after,
so the tree, and the bits, are those of a stable sort of the raw ids.

Ids outside ``[0, num_rows)`` contribute nothing, as the lookup gives them
zero rows.  The wrappers launch the kernels for CUDA tensors and raise if
they cannot; they use the plain versions only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import threading
from types import SimpleNamespace
from typing import Tuple

import torch

# kernel launches so far (the gradient, and the radix sort on any path:
# the gradient's, K7's and the fused Adam's); a run resets them and reads
# them to show the path went through the kernels
LAUNCHES = 0
SORT_LAUNCHES = 0

MAX_DIGIT_BITS = 8  # a pass sorts on at most 256 buckets (csrc/radix_sort.cuh)
MAX_ROWS = 2 ** 31 - 1

_FN = None
_SIDE = {}  # device index -> the library's second stream, as a torch stream
_LOCK = threading.Lock()


def sort_plan(num_rows: int) -> Tuple[int, int, int]:
    """(key bits, digit bits, passes) of the radix sort for a table of
    ``num_rows`` rows: its keys ``clamp(id, -1, num_rows) + 1`` lie in
    ``[0, num_rows + 1]``, so they need ``bit_length(num_rows + 1)`` bits,
    cut into as few passes of at most MAX_DIGIT_BITS bits as cover them,
    each of the same width.  21 bits, 3 passes of 7, at 1,605,632 rows."""
    if not 1 <= num_rows <= MAX_ROWS:
        raise ValueError(f"the table needs 1 to {MAX_ROWS} rows, got {num_rows}")
    key_bits = (num_rows + 1).bit_length()
    passes = -(-key_bits // MAX_DIGIT_BITS)
    return key_bits, -(-key_bits // passes), passes


def sort_ids_reference(ids: torch.Tensor, num_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``sort_ids``: a stable ``torch.sort`` of the
    clamped ids, its permutation cast to int32."""
    sorted_ids, perm = torch.sort(ids.clamp(-1, num_rows), stable=True)
    return sorted_ids, perm.to(torch.int32)


def _check_ids(ids: torch.Tensor) -> None:
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be a 1-D int32 tensor, got {tuple(ids.shape)} {ids.dtype}")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no table kernel for device {ids.device}")


def sort_ids(ids: torch.Tensor, num_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of [N] int32 fused ids of a ``num_rows``-row table on the
    keys ``clamp(id, -1, num_rows)`` -> (the clamped ids in ascending order,
    the batch position of each sorted entry), both int32: the prep of both
    table kernels.  In-range ids keep the positions a stable sort of the raw
    ids gives them."""
    _check_ids(ids)
    sort_plan(num_rows)
    if ids.device.type == "cpu":
        return sort_ids_reference(ids, num_rows)
    ids = ids.contiguous()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        workspace = _sort_begin(ids, num_rows, 0, False, stream)
        return _sort_finish(ids, num_rows, workspace, 0, stream)


def table_grad_reference(ids: torch.Tensor, rows: torch.Tensor,
                         num_rows: int) -> torch.Tensor:
    """Plain PyTorch version: [N] ids, [N, D] rows -> [num_rows, D].  Ids
    out of range add into one spare row past the end, which is dropped (no
    shape depends on the data, so the card needs no sync)."""
    spill = torch.where((ids >= 0) & (ids < num_rows), ids, num_rows).long()
    grad = rows.new_zeros((num_rows + 1, rows.shape[1]))
    return grad.index_add_(0, spill, rows)[:num_rows]


def check_inputs(ids: torch.Tensor, rows: torch.Tensor, num_rows: int) -> None:
    _check_ids(ids)
    if rows.dim() != 2 or rows.dtype != torch.float32 or rows.shape[0] != ids.shape[0]:
        raise ValueError(f"rows must be float32 [{ids.shape[0]}, D], got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if rows.shape[1] < 1:
        raise ValueError("rows must have at least one column")
    if num_rows <= 0:
        raise ValueError(f"the table needs at least one row, got {num_rows}")
    if ids.device != rows.device:
        raise ValueError(f"ids and rows must share a device, got {ids.device}, {rows.device}")


def _functions(device: torch.device) -> SimpleNamespace:
    """The library's entry points, typed, with ``device`` (the current
    device) ready for the fill (``_side_stream``); the library loads at the
    first call."""
    global _FN
    with _LOCK:
        if _FN is None:
            _FN = _load()
        if device.index not in _SIDE:
            with torch.cuda.device(device):
                handle = _FN.fill_stream_create()
            if not handle:
                raise RuntimeError(f"could not ready {device} for the zero fill")
            _SIDE[device.index] = torch.cuda.ExternalStream(handle, device=device)
    return _FN


def _load() -> SimpleNamespace:
    from . import _build

    lib = _build.load("embedding_grad")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

    def typed(fn, restype, *argtypes):
        fn.argtypes, fn.restype = list(argtypes), restype
        return fn

    return SimpleNamespace(
        levels=typed(lib.rp_embedding_grad_levels_f32, i32,
                     *[ptr] * 3, i64, ptr, i64, i32, ptr, i64, ptr, ptr),
        grad_words=typed(lib.rp_embedding_grad_workspace_words, i64, i64, i32),
        count_words=typed(lib.rp_embedding_grad_count_words, i64, i64),
        sort_words=typed(lib.rp_radix_sort_workspace_words, i64, i64, i32, i32, i64),
        sort_begin=typed(lib.rp_radix_sort_begin, i32, ptr, i64, i64, i32, i32, i32, ptr,
                         i64, i64, i32, ptr),
        sort_finish=typed(lib.rp_radix_sort_finish, i32, ptr, i64, i64, i32, i32, i32, ptr,
                          ptr, ptr, i64, i64, ptr),
        mark_rows=typed(lib.rp_mark_rows, i32, ptr, i64, i64, ptr, i64, ptr),
        fill_unmarked=typed(lib.rp_fill_unmarked_f32, i32, ptr, i64, i32, ptr, ptr),
        fill_stream_create=typed(lib.rp_fill_stream_create, ptr))


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _sort_begin(ids: torch.Tensor, num_rows: int, head: int, mark: bool,
                stream: int) -> torch.Tensor:
    """The sort's first launches on ``stream``; returns its workspace, whose
    first ``head`` words it zeroes for the caller, and, with ``mark``, sets
    the row marks in the first ceil(num_rows / 32) of them."""
    fns = _functions(ids.device)
    key_bits, digit_bits, passes = sort_plan(num_rows)
    n = ids.numel()
    workspace = torch.empty(max(1, fns.sort_words(n, digit_bits, passes, head)),
                            dtype=torch.int32, device=ids.device)
    _check_launch(fns.sort_begin(ids.data_ptr(), n, num_rows, key_bits, digit_bits, passes,
                                 workspace.data_ptr(), workspace.numel(), head, int(mark),
                                 stream), "radix sort")
    return workspace


def _sort_finish(ids: torch.Tensor, num_rows: int, workspace: torch.Tensor, head: int,
                 stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sort's passes on ``stream``, after ``_sort_begin``."""
    global SORT_LAUNCHES
    sorted_ids, perm = torch.empty_like(ids), torch.empty_like(ids)
    _check_launch(_functions(ids.device).sort_finish(
        ids.data_ptr(), ids.numel(), num_rows, *sort_plan(num_rows), sorted_ids.data_ptr(),
        perm.data_ptr(), workspace.data_ptr(), workspace.numel(), head, stream),
        "radix sort")
    SORT_LAUNCHES += 1
    return sorted_ids, perm


def _side_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """The library's second stream on ``device``, made when the library
    loads on the device (``_functions``) and shared by every caller there:
    calls from other streams queue their fills on it one after another."""
    _functions(device)
    return _SIDE[device.index]


def _levels(sorted_ids: torch.Tensor, perm: torch.Tensor, rows: torch.Tensor,
            grad: torch.Tensor, stream: int, counts: int = None) -> None:
    """The levels on ``stream``; ``counts``: the address of their counts,
    zeroed already, or None to zero their own."""
    fns = _functions(rows.device)
    scratch = torch.empty(fns.grad_words(sorted_ids.numel(), rows.shape[1]),
                          dtype=torch.float32, device=rows.device)
    _check_launch(fns.levels(sorted_ids.data_ptr(), perm.data_ptr(), rows.data_ptr(),
                             sorted_ids.numel(), grad.data_ptr(), grad.shape[0], rows.shape[1],
                             scratch.data_ptr(), scratch.numel(), counts, stream),
                  "embedding_grad kernel")


def _overlapped(ids: torch.Tensor, rows: torch.Tensor, num_rows: int,
                presorted: Tuple[torch.Tensor, torch.Tensor] = None) -> torch.Tensor:
    """Sort (unless ``presorted``), zero the untouched rows on the second
    stream, sum the touched ones on the current stream; joined on return.
    The row marks and the levels' counts share the head of one workspace,
    zeroed by one memset: the sort's, or the mark pass's."""
    global LAUNCHES
    dev = rows.device
    grad = torch.empty((num_rows, rows.shape[1]), dtype=rows.dtype, device=dev)
    with torch.cuda.device(dev):
        fns = _functions(dev)
        main = torch.cuda.current_stream(dev)
        stream = main.cuda_stream
        mark_words = (num_rows + 31) // 32
        head = mark_words + fns.count_words(ids.numel() if presorted is None
                                            else presorted[0].numel())
        if presorted is None:  # the sort's first launch marks the rows
            workspace = _sort_begin(ids, num_rows, head, True, stream)
        else:  # a small pass over the sorted ids marks them
            workspace = torch.empty(head, dtype=torch.int32, device=dev)
            _check_launch(fns.mark_rows(presorted[0].data_ptr(), presorted[0].numel(), num_rows,
                                        workspace.data_ptr(), head, stream), "row marks")
        side = _side_stream(dev)
        side.wait_stream(main)
        try:
            _check_launch(fns.fill_unmarked(grad.data_ptr(), num_rows, rows.shape[1],
                                            workspace.data_ptr(), side.cuda_stream), "zero fill")
            if presorted is None:
                presorted = _sort_finish(ids, num_rows, workspace, head, stream)
            _levels(*presorted, rows, grad, stream, workspace.data_ptr() + 4 * mark_words)
        finally:
            main.wait_stream(side)
    LAUNCHES += 1
    return grad


def launch(sorted_ids: torch.Tensor, perm: torch.Tensor, rows: torch.Tensor,
           num_rows: int) -> torch.Tensor:
    """The kernel alone, on ``sort_ids``' output: -> [num_rows, D].  A pass
    of its own marks the touched rows; then the fill of the others runs on
    the second stream beside the levels, as in ``table_grad``."""
    return _overlapped(None, rows.contiguous(), num_rows, (sorted_ids, perm))


def table_grad(ids: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """[N] int32 fused ids, [N, D] f32 cotangent rows -> the dense
    [num_rows, D] table gradient, zeros where no id falls."""
    check_inputs(ids, rows, num_rows)
    if ids.device.type == "cpu":
        return table_grad_reference(ids, rows, num_rows)
    return _overlapped(ids.contiguous(), rows.contiguous(), num_rows)


def sorted_segment_accumulate(flat_ids: torch.Tensor, rows: torch.Tensor,
                              num_rows: int) -> torch.Tensor:
    """K7's counterpart under the JAX name: [N] ids of any integer type,
    [N, D] f32 rows -> the dense [num_rows, D] gradient, the ids sorted on
    the device (``table_grad``)."""
    return table_grad(flat_ids.to(torch.int32), rows, num_rows)
