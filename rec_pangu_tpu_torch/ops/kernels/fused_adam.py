"""One dense-semantics Adam step on an embedding table, its gradient summed
in the same pass.

Replaces the JAX package's K3 (``rec_pangu_tpu/ops/kernels/fused_adam.py``:
``_adam_tile_kernel`` behind ``planned_adam_update``).  For every table row
r, with g the sum of r's cotangent rows (0 when r is absent), in optax's
order (that file's lines 165-171)::

    m = b1*m + (1-b1)*g
    v = b2*v + (1-b2)*g*g
    p = p - lr*(m*inv_b1c) / (sqrt(v*inv_b2c) + eps)

Rows absent from the batch still decay their moments and are still nudged
by the bias-corrected first moment: this is Adam over the dense gradient,
as ``torch.optim.Adam`` over an ``nn.Embedding``'s dense gradient would do.

The CUDA kernel (``rec_pangu_tpu_torch/csrc/fused_adam.cu``) sums each run
of equal ids with K2's fixed tree of warps (``csrc/segment_sum.cuh``; the
prep is ``sort_ids`` from ``embedding_grad.py``, the package's radix sort
over the table's key bits) into a compact buffer of
run sums, then gives each block a tile of table rows (``tile_plan``): it
gathers the tile's run sums into shared memory, then streams its slice of
p, m and v once, as float4s at every width, and updates them in place, so
the dense gradient never reaches device memory.  Bound: bytes, 6 table
passes plus the rows and ids: 1.250 GB, 0.373 ms at 3.35 TB/s at the bench
shape.  No float atomics: the bits repeat from run to run.

A step whose tables share their height (WDL's LR table beside its
embedding, AFN's two) sorts its ids once (``sort_for``) and updates each
table on that sort (``update_sorted``).

Two options, as in the JAX kernel: ``dense``, a ``[V, D]`` f32 gradient
added to the summed rows before the Adam math (the sequence step's streamed
softmax-CE item gradient, K3's ``has_dense`` stream), and moments stored as
bfloat16 (``mu``/``nu`` of that dtype; ``REC_PANGU_TPU_MOMENT_DTYPE=bf16``
in the train steps), loaded exactly into f32 and stored rounded to nearest
even, all arithmetic f32.  Without either the kernel is the one it was.

The plain version runs the same operations, each rounded on its own, so a
row whose gradient sums the same terms in the same order (a row hit at most
once, always) gets the same bits; a row hit more often may differ by the
rounding of its gradient sum (``index_add_`` sums in batch order on the CPU
and with atomics on the card, the kernel by chunks of 32 sorted entries).

The wrapper launches the kernel for CUDA tensors and raises if it cannot; it
uses the plain version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .embedding_grad import _check_ids, check_inputs, sort_ids, table_grad_reference

# kernel launches so far; a run resets it and reads it to show the path
# went through the kernel
LAUNCHES = 0

MAX_DIM = 8192  # a row's gradient fits one block's shared memory
TILE_FLOATS = 2048  # the most floats of a tile: 8 KB of shared gradient
TILES_PER_SM = 4  # the plan gives each SM at least this many tiles
TILE_ALIGN = 32  # a tile's slice is whole 128-byte lines of float32
SHARED_LIMIT = 48 * 1024  # bytes of shared memory a block takes without opting in

_FN = None
_SMS = {}  # device index -> its multiprocessor count


class TilePlan(NamedTuple):
    tile_rows: int     # table rows a block owns
    grid: int          # blocks: one a tile
    shared_bytes: int  # a block's gradient tile and its list of run starts
    width: int         # floats a thread loads and stores at once (4, or 1)


def tile_plan(num_rows: int, dim: int, sms: int) -> TilePlan:
    """The launch of the tile kernel for a [num_rows, dim] table on a card
    of ``sms`` multiprocessors.  A tile's slice is whole 128-byte lines
    (``tile_rows * dim`` a multiple of TILE_ALIGN floats: a block shares no
    line of p, m or v with another, and every slice of an aligned array
    starts on a 16-byte boundary, of a bfloat16 one on a 64-byte one), at
    most TILE_FLOATS floats and SHARED_LIMIT bytes of shared memory, and no
    larger than it takes to give every SM TILES_PER_SM tiles.  Where whole
    lines do not fit, a row is a tile of its own, of float4s when
    ``dim % 4 == 0`` and of single floats otherwise.  At a given width the
    plan is the same for either moment dtype and with or without the dense
    stream."""
    if num_rows < 1 or not 1 <= dim <= MAX_DIM or sms < 1:
        raise ValueError(f"no tile plan for a [{num_rows}, {dim}] table on {sms} SMs")
    step = TILE_ALIGN // math.gcd(dim, TILE_ALIGN)  # rows that make whole lines
    most = min(TILE_FLOATS // dim, SHARED_LIMIT // ((dim + 1) * 4)) // step * step
    if most == 0:
        rows, width = 1, 4 if dim % 4 == 0 else 1
    else:
        fill = num_rows // (TILES_PER_SM * sms) // step * step  # rows that fill the card
        rows, width = min(most, max(step, fill)), 4
    return TilePlan(rows, -(-num_rows // rows), rows * (dim + 1) * 4, width)


def _sms(device: torch.device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device.index]


def adam_hyper(step: int, lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> torch.Tensor:
    """f32[8] = [lr, b1, b2, eps, 1/(1-b1^t), 1/(1-b2^t), 0, 0] at 1-based
    step t, computed in float32 as the JAX package's ``adam_hyper`` does.
    A CPU tensor: the kernel takes the values as arguments."""
    f = np.float32
    t = f(step)
    one = f(1.0)
    b1c = one - f(b1) ** t
    b2c = one - f(b2) ** t
    return torch.from_numpy(np.array(
        [f(lr), f(b1), f(b2), f(eps), one / b1c, one / b2c, 0.0, 0.0], np.float32))


def _hyper_values(hyper: torch.Tensor):
    if hyper.shape != (8,) or hyper.dtype != torch.float32:
        raise ValueError(f"hyper must be float32 [8] (adam_hyper), got "
                         f"{tuple(hyper.shape)} {hyper.dtype}")
    return hyper.cpu().tolist()[:6]


def planned_adam_update_reference(ids: torch.Tensor, rows: torch.Tensor,
                                  table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                                  hyper: torch.Tensor, dense: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, in place on ``table``, ``mu`` and ``nu``."""
    lr, b1, b2, eps, inv_b1c, inv_b2c = _hyper_values(hyper)
    g = table_grad_reference(ids, rows, table.shape[0])
    if dense is not None:
        g = g + dense
    # 1 - b1 and 1 - b2 are exact in float32 for f32 betas near 1
    new_mu = b1 * mu.float() + (1.0 - b1) * g
    new_nu = b2 * nu.float() + (1.0 - b2) * (g * g)
    table.sub_(lr * (new_mu * inv_b1c) / (torch.sqrt(new_nu * inv_b2c) + eps))
    mu.copy_(new_mu)  # to bfloat16: rounded to nearest even
    nu.copy_(new_nu)
    return table, mu, nu


MOMENT_DTYPES = (torch.float32, torch.bfloat16)


def _check(ids, rows, table, mu, nu, dense=None) -> None:
    check_inputs(ids, rows, table.shape[0])
    if rows.shape[1] > MAX_DIM:
        raise ValueError(f"D must be at most {MAX_DIM}, got {rows.shape[1]}")
    shape = (table.shape[0], rows.shape[1])
    arrays = [("table", table, (torch.float32,)), ("mu", mu, MOMENT_DTYPES),
              ("nu", nu, MOMENT_DTYPES)]
    if dense is not None:
        arrays.append(("dense", dense, (torch.float32,)))
    for name, t, dtypes in arrays:
        if t.dim() != 2 or t.dtype not in dtypes or t.shape != shape:
            raise ValueError(f"{name} must be {' or '.join(str(d) for d in dtypes)} "
                             f"{list(shape)}, got {tuple(t.shape)} {t.dtype}")
        if t.device != ids.device:
            raise ValueError(f"{name} is on {t.device}, the ids on {ids.device}")
    if mu.dtype != nu.dtype:
        raise ValueError(f"mu and nu must share a dtype, got {mu.dtype} and {nu.dtype}")


def _kernel():
    """(the launch, its scratch size in 4-byte words) from the library."""
    global _FN
    if _FN is None:
        from . import _build

        lib = _build.load("fused_adam")
        fn = lib.rp_fused_adam_f32
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p,
                                                ctypes.c_longlong] + [ctypes.c_void_p] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        words = lib.rp_fused_adam_workspace_words
        words.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        words.restype = ctypes.c_longlong
        _FN = fn, words
    return _FN


class SortedIds(NamedTuple):
    """A batch's fused ids made ready for every table of ``num_rows`` rows:
    on the card with ``sort_ids``' output beside them; on the CPU the ids
    alone (the plain version sums them in batch order)."""
    ids: torch.Tensor
    sorted_ids: Optional[torch.Tensor]
    perm: Optional[torch.Tensor]
    num_rows: int


def sort_for(ids: torch.Tensor, num_rows: int) -> SortedIds:
    """[N] int32 fused ids -> ``SortedIds`` for tables of ``num_rows`` rows:
    one radix sort on the card, shared by every such table's update."""
    _check_ids(ids)
    if ids.device.type == "cpu":
        return SortedIds(ids, None, None, num_rows)
    return SortedIds(ids, *sort_ids(ids, num_rows), num_rows)


def _check_height(plan: SortedIds, table: torch.Tensor) -> None:
    if plan.num_rows != table.shape[0]:
        raise ValueError(f"the ids were made ready for a table of {plan.num_rows} rows, "
                         f"this one has {table.shape[0]}")


def launch(plan: SortedIds, rows: torch.Tensor, table: torch.Tensor, mu: torch.Tensor,
           nu: torch.Tensor, hyper: torch.Tensor, dense: Optional[torch.Tensor] = None) -> None:
    """The kernel alone, on ``sort_for``'s card output; updates in place.
    Refuses ids made ready for a table of another height."""
    global LAUNCHES
    _check_height(plan, table)
    if plan.sorted_ids is None:
        raise ValueError("the fused Adam kernel needs ids sorted on the card (sort_for)")
    values = _hyper_values(hyper)
    if dense is not None:
        dense = dense.contiguous()
    for name, t in (("table", table), ("mu", mu), ("nu", nu)):
        if not t.is_contiguous():
            raise ValueError(f"the fused Adam kernel updates {name} in place: it must be "
                             f"contiguous")
    rows = rows.contiguous()
    dim, num_rows = rows.shape[1], table.shape[0]
    dev = table.device
    tile = tile_plan(num_rows, dim, _sms(dev)).tile_rows
    n = plan.sorted_ids.numel()
    fn, words = _kernel()
    scratch = torch.empty(words(n, num_rows, dim, tile), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(plan.sorted_ids.data_ptr(), plan.perm.data_ptr(), rows.data_ptr(), n,
                 scratch.data_ptr(), scratch.numel(), table.data_ptr(), mu.data_ptr(),
                 nu.data_ptr(), num_rows, dim, tile, *values,
                 None if dense is None else dense.data_ptr(), int(mu.dtype == torch.bfloat16),
                 stream)
    if err != 0:
        raise RuntimeError(f"fused_adam kernel launch failed: CUDA error {err}")
    LAUNCHES += 1


def update_sorted(plan: SortedIds, rows: torch.Tensor, table: torch.Tensor, mu: torch.Tensor,
                  nu: torch.Tensor, hyper: torch.Tensor, dense: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``planned_adam_update`` on ids made ready once (``sort_for``) for
    every table of their height."""
    _check(plan.ids, rows, table, mu, nu, dense)
    _check_height(plan, table)
    if plan.ids.device.type == "cpu":
        return planned_adam_update_reference(plan.ids, rows, table, mu, nu, hyper, dense)
    launch(plan, rows, table, mu, nu, hyper, dense)
    return table, mu, nu


def planned_adam_update(ids: torch.Tensor, rows: torch.Tensor, table: torch.Tensor,
                        mu: torch.Tensor, nu: torch.Tensor, hyper: torch.Tensor,
                        dense: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step on ``table`` [V, D] f32 and its moments ``mu``/``nu``
    (same shape, both f32 or both bfloat16), in place, from [N] int32 fused
    ids and their [N, D] f32 cotangent rows, plus the [V, D] f32 ``dense``
    gradient when given; ``hyper`` from ``adam_hyper``.  Returns the three."""
    return update_sorted(sort_for(ids, table.shape[0]), rows, table, mu, nu, hyper, dense)
