"""Exact row top-k: each row's k largest float32 scores, best first, with
their column ids as int32.

Replaces no TPU kernel: the JAX package calls ``jax.lax.top_k``
(``rec_pangu_tpu/serving/scorer.py:72``).  The port's retrieval
(``serving/scorer.py``) takes it over its ``[B, N]`` scores in place of
``torch.topk``, whose multi-block radix select reads the scores about five
times.  The CUDA kernel (``rec_pangu_tpu_torch/csrc/row_topk.cu``) reads them
once for a histogram of each row's top key digit and each chunk's largest
key, then again only the chunks that may hold a column at or above the digit
of the k-th key, whose columns it keeps and sorts in shared memory.  The
plain version below takes the same steps but the chunks' maxima, which
change what is read and not the answer.

Order: a score's 32-bit key flips every bit of a negative and sets the sign
bit of a non-negative; every NaN is 0xffffffff, above +inf, as
``torch.topk`` orders it.  Ties go to the smallest ids: columns rank by the
64 bits ``V = key << 32 | ~id`` descending, which no two columns share, so
the answer is the same bits on every run and a valid ``torch.topk`` answer.
A row whose candidates at the first digit would overflow the buffer
(``CAPACITY``) refines on the next digits of V (``LEVELS``), re-reading that
row's chunks that may hold them; ``refined_rows`` counts such rows on the
device, for checks.

``row_topk`` launches the kernel for a CUDA float32 call it takes
(``kernel_takes``: k <= ``KMAX``) and runs ``torch.topk`` on the card past
that (counted in ``PLAIN_ROUTE``); on the CPU it runs the plain version,
``row_topk_reference``, which repeats the kernel's steps in PyTorch, within
the kernel's limits and ``torch.topk`` past them.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

LAUNCHES = 0     # calls that ran the kernel
PLAIN_ROUTE = 0  # calls on the card past the kernel's limits: torch.topk ran

KMAX = 256            # the finish sorts at most CAPACITY and writes at most KMAX a row
CAPACITY = 1016       # candidates a row: with the histogram, 24 KiB of workspace a row
                      # (and 4 more for 1 M columns' chunk maxima)
MAX_CAPACITY = 2048   # the finish's shared-memory sort
MAX_N = 2**31 - 1     # ids are int32
BINS = 4096           # the widest digit, 12 bits
STATE_WORDS = 8
# (bits of V fixed, digit width) of each level: 12, 10 and 10 bits of the
# key, then 11, 11 and 10 of ~id
LEVELS = ((0, 12), (12, 10), (22, 10), (32, 11), (43, 11), (54, 10))
TARGET_BLOCKS = 4224  # histogram and filter blocks: four waves of 132 SMs x 8 blocks
MIN_SLICE = 8192      # columns a block at least
CHUNK = 512           # columns a warp reads at once; the filter skips a chunk whose
                      # largest key cannot reach the k-th key's digit

_FN = None
_REFINED: Dict[torch.device, torch.Tensor] = {}
_ALL = (1 << 32) - 1


def plan_slices(B: int, N: int) -> int:
    """Blocks a row in the histogram and filter passes: enough (row, slice)
    blocks to fill the card, and at least ``MIN_SLICE`` columns a block."""
    want = -(-TARGET_BLOCKS // max(B, 1))
    return max(1, min(want, N // MIN_SLICE))


def workspace_words(B: int, N: int, capacity: int = CAPACITY) -> int:
    """4-byte words of workspace for B rows of N, as the kernel lays it out
    (and checks): candidates [B, capacity] u64, histograms [B, BINS], row
    states, the levels' row lists, each chunk's largest key (16 bits)."""
    chunks = -(-N // CHUNK)
    return (2 * B * capacity + B * BINS + B * STATE_WORDS + 8 + len(LEVELS) * B
            + (B * chunks + 1) // 2)


def check_inputs(scores: torch.Tensor, k: int) -> None:
    """Raise ValueError on a call no route takes."""
    if scores.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no row top-k for device {scores.device}")
    if scores.dtype != torch.float32:
        raise ValueError(f"scores must be float32, got {scores.dtype}")
    if scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError(f"contiguous scores [B, N] expected, got shape {tuple(scores.shape)}, "
                         f"contiguous={scores.is_contiguous()}")
    if not 1 <= k <= scores.shape[1]:
        raise ValueError(f"k must lie in [1, {scores.shape[1]}], got {k}")


def kernel_takes(k: int, N: int) -> bool:
    """Whether the kernel takes k of N columns."""
    return 1 <= k <= KMAX and k <= N <= MAX_N


def routes_to_kernel(device: torch.device, k: int, N: int) -> bool:
    """True on the card for a call the kernel takes; False on the CPU, and on
    the card past the limits (counted in ``PLAIN_ROUTE``)."""
    global PLAIN_ROUTE
    if device.type != "cuda":
        return False
    if kernel_takes(k, N):
        return True
    PLAIN_ROUTE += 1
    return False


def _refined(device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counter = _REFINED.get(device)
    if counter is None:
        with torch.inference_mode(False):  # a normal tensor: updated in and out of the mode
            counter = _REFINED[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return counter


def refined_rows(device) -> int:
    """Rows that refined past the first digit, over every call on
    ``device`` so far (kernel and plain version alike).  Reads the device."""
    return int(_refined(torch.device(device)).item())


# ---------------------------------------------------------------- plain version

def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """The scores' order-preserving 32-bit keys, as int64 in [0, 2**32)."""
    u = scores.view(torch.int32).to(torch.int64) & _ALL
    key = torch.where(u >= 1 << 31, _ALL - u, u | (1 << 31))
    return torch.where(torch.isnan(scores), _ALL, key)




def _digit(key: torch.Tensor, lo: torch.Tensor, bits: int, width: int) -> torch.Tensor:
    if bits + width <= 32:
        return (key >> (32 - bits - width)) & ((1 << width) - 1)
    return (lo >> (64 - bits - width)) & ((1 << width) - 1)


def _matches(key: torch.Tensor, lo: torch.Tensor, bits: int, pk: torch.Tensor,
             pl: torch.Tensor) -> torch.Tensor:
    """V's top ``bits`` bits equal to the prefix (pk, pl), a row each."""
    if bits <= 32:
        return (key >> (32 - bits)) == pk[:, None]
    return (key == pk[:, None]) & ((lo >> (64 - bits)) == pl[:, None])


def _reaches(key: torch.Tensor, lo: torch.Tensor, bits: int, pk: torch.Tensor,
             pl: torch.Tensor) -> torch.Tensor:
    """V's top ``bits`` bits at or above the prefix (pk, pl), a row each."""
    if bits <= 32:
        return (key >> (32 - bits)) >= pk[:, None]
    return (key > pk[:, None]) | ((key == pk[:, None]) & ((lo >> (64 - bits)) >= pl[:, None]))


def _threshold(hist: torch.Tensor, need: torch.Tensor):
    """From the top of each row's histogram: (the bin b* that holds the
    need-th count, the count above b*, the count in b*)."""
    incl = hist.flip(1).cumsum(1).flip(1)
    b = (incl >= need[:, None]).sum(1) - 1
    cnt = hist.gather(1, b[:, None])[:, 0]
    return b, incl.gather(1, b[:, None])[:, 0] - cnt, cnt


def _refine(scores: torch.Tensor, b0: torch.Tensor, above: torch.Tensor, k: int,
            capacity: int) -> torch.Tensor:
    """The levels past the first for rows whose first-digit candidates
    overflow ``capacity``: each row's selected columns [R, N] bool."""
    R, N = scores.shape
    key = order_keys(scores)
    lo = _ALL - torch.arange(N, dtype=torch.int64, device=scores.device)
    pk, pl = b0.clone(), torch.zeros_like(b0)
    bits = torch.full_like(b0, LEVELS[1][0])
    above = above.clone()
    pending = torch.ones(R, dtype=torch.bool, device=scores.device)
    for fixed, width in LEVELS[1:]:
        rows = pending.nonzero()[:, 0]
        if not rows.numel():
            break
        kr = key[rows]
        match = _matches(kr, lo, fixed, pk[rows], pl[rows])
        hist = torch.zeros(rows.numel(), 1 << width, dtype=torch.int64, device=scores.device)
        hist.scatter_add_(1, _digit(kr, lo.expand_as(kr), fixed, width), match.to(torch.int64))
        b, acc, cnt = _threshold(hist, k - above[rows])
        if fixed + width <= 32:
            pk[rows] = (pk[rows] << width) | b
        else:
            pl[rows] = (pl[rows] << width) | b
        above[rows] += acc
        bits[rows] = fixed + width
        pending[rows] = (above[rows] + cnt > capacity) & (fixed + width < 64)
    take = torch.empty(R, N, dtype=torch.bool, device=scores.device)
    for fixed in bits.unique().tolist():
        rows = (bits == fixed).nonzero()[:, 0]
        take[rows] = _reaches(key[rows], lo, fixed, pk[rows], pl[rows])
    return take


def _select_rows(scores: torch.Tensor, k: int, capacity: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The kernel's steps on a block of rows: (values, ids int32, rows refined)."""
    R, N = scores.shape
    dev = scores.device
    # the first digit, the key's top 12 bits, in int32 and in place: the key
    # is u ^ (u >> 31 | sign bit), 0xffffffff for NaN
    u = scores.view(torch.int32)
    d0 = u >> 31
    d0 |= -(1 << 31)
    d0 ^= u
    d0 >>= 32 - LEVELS[0][1]
    d0 &= BINS - 1
    d0.masked_fill_(torch.isnan(scores), BINS - 1)
    rows = torch.arange(R, dtype=torch.int32, device=dev)[:, None] * BINS
    hist = torch.bincount((d0 + rows).flatten(), minlength=R * BINS).view(R, BINS)
    b0, above, cnt = _threshold(hist, torch.full((R,), k, dtype=torch.int64, device=dev))
    take = d0 >= b0[:, None]
    deep = (above + cnt > capacity).nonzero()[:, 0]
    if deep.numel():
        take[deep] = _refine(scores[deep], b0[deep], above[deep], k, capacity)
    # the filter: the selected columns into a buffer of `capacity` a row
    # (their count lies in [k, capacity])
    r, c = take.nonzero(as_tuple=True)
    counts = torch.bincount(r, minlength=R)
    if bool((counts > capacity).any()) or bool((counts < k).any()):
        raise RuntimeError(f"row top-k selected {counts.tolist()} columns a row; "
                           f"[{k}, {capacity}] expected")
    pos = torch.arange(r.numel(), device=dev) - (counts.cumsum(0) - counts)[r]
    v = (order_keys(scores[r, c]) - (1 << 31)) * (1 << 32) + (_ALL - c)  # V - 2**63
    cand = torch.full((R, capacity), -(1 << 63), dtype=torch.int64, device=dev)
    cand[r, pos] = v
    # the finish: the buffer sorted descending, the first k
    best = cand.sort(dim=1, descending=True).values[:, :k]
    ids = _ALL - (best & _ALL)
    return scores.gather(1, ids), ids.to(torch.int32), int(deep.numel())


def row_topk_reference(scores: torch.Tensor, k: int, capacity: int = CAPACITY,
                       rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, ``rows`` rows at a time (as many
    as hold 2**24 scores by default): (values [B, k] f32, ids [B, k] int32).
    Adds the rows that refined to ``refined_rows``."""
    if not k <= capacity <= MAX_CAPACITY:
        raise ValueError(f"capacity must lie in [k, {MAX_CAPACITY}], got {capacity} for k={k}")
    B, N = scores.shape
    rows = rows or max(1, (1 << 24) // max(N, 1))
    values = torch.empty(B, k, dtype=torch.float32, device=scores.device)
    ids = torch.empty(B, k, dtype=torch.int32, device=scores.device)
    refined = 0
    for r0 in range(0, B, rows):
        values[r0:r0 + rows], ids[r0:r0 + rows], n = _select_rows(scores[r0:r0 + rows], k,
                                                                   capacity)
        refined += n
    if B:
        _refined(scores.device).add_(refined)
    return values, ids


# ---------------------------------------------------------------- the kernel

def bind(lib):
    """The launch function of a loaded ``row_topk`` library."""
    fn = lib.rp_row_topk_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def _function():
    """``bind`` of the package's library, built at first use."""
    global _FN
    if _FN is None:
        from . import _build

        _FN = bind(_build.load("row_topk"))
    return _FN


def launch(scores: torch.Tensor, k: int,
           capacity: int = CAPACITY) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on checked CUDA scores: (values [B, k] f32, ids [B, k]
    int32), ``plan_slices`` blocks a row."""
    global LAUNCHES
    check_inputs(scores, k)
    if scores.device.type != "cuda":
        raise ValueError(f"the row top-k kernel runs on CUDA tensors, got {scores.device}")
    B, N = scores.shape
    if not kernel_takes(k, N):
        raise ValueError(f"the row top-k kernel takes 1 <= k <= {KMAX} and N <= {MAX_N}; "
                         f"got k={k}, N={N}")
    if not k <= capacity <= MAX_CAPACITY:
        raise ValueError(f"capacity must lie in [k, {MAX_CAPACITY}], got {capacity} for k={k}")
    values = torch.empty(B, k, dtype=torch.float32, device=scores.device)
    ids = torch.empty(B, k, dtype=torch.int32, device=scores.device)
    if B == 0:
        return values, ids
    fn = _function()
    n_words = workspace_words(B, N, capacity)
    work = torch.empty(n_words, dtype=torch.float32, device=scores.device)
    refined = _refined(scores.device)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = fn(scores.data_ptr(), values.data_ptr(), ids.data_ptr(), work.data_ptr(), n_words,
                 B, N, int(k), int(capacity), plan_slices(B, N), refined.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"row top-k kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return values, ids


def row_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's k largest scores, best first, ties to the smallest ids:
    (values [B, k] f32, ids [B, k] int32).  The kernel on the card for a call
    it takes and its plain version on the CPU; ``torch.topk`` past the
    kernel's limits on either."""
    check_inputs(scores, k)
    N = scores.shape[1]
    if routes_to_kernel(scores.device, k, N):
        return launch(scores, k)
    if scores.device.type == "cpu" and kernel_takes(k, N):
        return row_topk_reference(scores, k)
    values, ids = torch.topk(scores, k, dim=1)
    return values, ids.to(torch.int32)
