"""The K-max softmax cross-entropy's kernels: its logsumexp and the softmax
term of its gradient.

Replaces the JAX package's K5f and K5b (``rec_pangu_tpu/ops/kernels/
multimax_ce.py``: ``_fwd_kernel`` behind ``multimax_lse``, ``_bwd_kernel``
behind ``multimax_grads``).  For users ``u [B, K, D]`` and an item table
``items [rows, D]``::

    z[b, v] = max_k u[b, k] . items[v]        (ties: the lowest k)
    lse[b]  = logsumexp over v < valid_v of z[b, v]

rows at or past ``valid_v`` (the table's padding) score -1e30 and add
nothing; with ``zero_row0`` row 0 reads as a zero vector (``z = 0``, in the
denominator, no gradient).  The backward, unscaled and without the
positive-class terms (``ops/softmax_ce.py`` applies both)::

    p[b, v]    = exp(z[b, v] - lse[b])          (0 at padding and row 0)
    du[b, k]   = sum_v p[b, v] [k*(b, v) = k] items[v]
    d_items[v] = sum_b p[b, v] u[b, k*(b, v)]

The CUDA kernels (``rec_pangu_tpu_torch/csrc/multimax_ce.cu``) never hold
the ``[B, K, V]`` logits.  The forward and the backward's P compute z by one
routine, float32 products on the CUDA cores in the plain version's order, so
P's z is the forward's.  The forward keeps each block's running (max, sum)
over its range of item tiles and combines the ranges in order.  The backward
runs chunk by chunk over the item axis (``grads_plan``): launch P computes
z, k* and p once per (b, v) and keeps p and k* of the chunk in a workspace;
U sums the masked du product of each range of items from them; S adds the
ranges' du in order; D reads p and k* for the chunk's ``d_items`` rows.  No
atomics.  Bound: operations, ``2 B K D V`` FLOP forward and
``2 B V D (K + 2)`` backward.  The wrappers launch them for CUDA tensors and
raise if a launch fails; a shape past their limits (``kernel_takes``: K <=
``MAX_K``, D <= ``MAX_D``) runs the plain versions below on the card too
(counted in ``PLAIN_ROUTE``), as it does on the CPU: the chunked form of the
JAX package's scan.  K5b takes the route K5f took, since both see one
(K, D).  ``pairs_reference`` and
``items_reference`` are the backward's stages in plain PyTorch, for checks.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

LAUNCHES = 0           # forward launches (K5f)
BACKWARD_LAUNCHES = 0  # backward launches (K5b)
PLAIN_ROUTE = 0        # calls on the card past the kernels' limits: the plain version ran

MAX_K = 4     # interests: a thread holds 2 users x K x 8 items of logits
MAX_D = 128
CHUNK = 131_072  # items a chunk of the plain versions
_NEG = -1e30     # a finite -inf: exp gives exactly 0
USER_TILE, ITEM_TILE = 32, 128  # the kernels' users and items a tile
WORKSPACE_BUDGET = 1 << 30      # bytes of the backward's workspace, whatever the table's rows
BWD_TARGET_BLOCKS = 1056        # P blocks of a chunk: 4 waves of 132 SMs at two blocks an SM

_LSE_FN = None
_GRADS_FN = None


def _chunk_z(u: torch.Tensor, chunk: torch.Tensor, base: int, valid_v: int,
             zero_row0: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z [B, C] masked, k* [B, C]) of one chunk: the running max over the
    interests with a strict ``>``, so a tie keeps the lowest k."""
    z = torch.matmul(u[:, 0], chunk.t())
    ks = torch.zeros(z.shape, dtype=torch.int64, device=z.device)
    for k in range(1, u.shape[1]):
        lk = torch.matmul(u[:, k], chunk.t())
        upd = lk > z
        z = torch.where(upd, lk, z)
        ks = torch.where(upd, k, ks)
    stop = base + chunk.shape[0]
    if stop > valid_v:
        z[:, max(valid_v - base, 0):] = _NEG
    if zero_row0 and base == 0:
        z[:, 0] = 0.0
    return z, ks


def multimax_lse_reference(u: torch.Tensor, items: torch.Tensor, valid_v: int,
                           zero_row0: bool = False, chunk: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch K5f: the JAX scan's online logsumexp over item chunks."""
    chunk = chunk or CHUNK
    B = u.shape[0]
    m = torch.full((B,), _NEG, dtype=torch.float32, device=u.device)
    s = torch.zeros(B, dtype=torch.float32, device=u.device)
    for base in range(0, items.shape[0], chunk):
        z, _ = _chunk_z(u, items[base:base + chunk], base, valid_v, zero_row0)
        m2 = torch.maximum(m, z.amax(dim=-1))
        s = s * torch.exp(m - m2) + torch.exp(z - m2[:, None]).sum(dim=-1)
        m = m2
    return m + torch.log(s)


class GradsPlan(NamedTuple):
    """The backward's chunks: ``chunks`` chunks of ``chunk_tiles`` item
    tiles (the last one may be shorter), ``tiles_per_split`` tiles a P or U
    block, ``splits`` such blocks of a full chunk per user group; ``words`` of
    workspace: p [B, chunk] f32, k* [B, chunk] u8 and ``splits`` partial
    du [B, K, D]."""
    chunk_tiles: int
    tiles_per_split: int
    splits: int
    chunks: int
    words: int

    @property
    def chunk_items(self) -> int:
        return self.chunk_tiles * ITEM_TILE


def grads_plan(B: int, K: int, D: int, rows: int, budget: int = WORKSPACE_BUDGET) -> GradsPlan:
    """As many item tiles a chunk as fit ``budget`` bytes of workspace
    beside the du partials, at least one, then the tiles spread evenly over
    the chunks; a chunk's P blocks near ``BWD_TARGET_BLOCKS``."""
    user_tiles = -(-B // USER_TILE)
    tiles = -(-rows // ITEM_TILE)
    splits = max(1, min(-(-BWD_TARGET_BLOCKS // user_tiles), tiles))
    per_tile = B * ITEM_TILE * 5
    fit = max(1, (budget - splits * B * K * D * 4) // per_tile)
    chunks = -(-tiles // fit)
    chunk_tiles = -(-tiles // chunks)
    tiles_per_split = -(-chunk_tiles // min(splits, chunk_tiles))
    splits = -(-chunk_tiles // tiles_per_split)
    pairs = B * chunk_tiles * ITEM_TILE
    return GradsPlan(chunk_tiles, tiles_per_split, splits, chunks,
                     pairs + pairs // 4 + splits * B * K * D)


def pairs_reference(u: torch.Tensor, chunk: torch.Tensor, base: int, lse: torch.Tensor,
                    valid_v: int, zero_row0: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K5b's first stages (launches P, U and S) on the items ``chunk``
    from row ``base``: (p [B, C] f32, 0 at padding and row 0; k* [B, C] u8;
    the chunk's du [B, K, D])."""
    z, ks = _chunk_z(u, chunk, base, valid_v, zero_row0)
    p = torch.exp(z - lse[:, None])
    if base + chunk.shape[0] > valid_v:
        p[:, max(valid_v - base, 0):] = 0.0
    if zero_row0 and base == 0:
        p[:, 0] = 0.0
    ks = ks.to(torch.uint8)
    du = torch.stack([torch.matmul(p * (ks == k), chunk) for k in range(u.shape[1])], 1)
    return p, ks, du


def items_reference(u: torch.Tensor, p: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Plain K5b's last stage (launch D): the d_items rows of a chunk from
    its p and k* [B, C], with no z: sum_k (p [k* = k])^T u[:, k]."""
    d = torch.zeros(p.shape[1], u.shape[2], dtype=u.dtype, device=u.device)
    for k in range(u.shape[1]):
        d += torch.matmul((p * (ks == k)).t(), u[:, k])
    return d


def multimax_grads_reference(u: torch.Tensor, items: torch.Tensor, lse: torch.Tensor,
                             valid_v: int, zero_row0: bool = False,
                             chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K5b: (du [B, K, D], d_items [rows, D]), unscaled."""
    chunk = chunk or CHUNK
    du = torch.zeros_like(u)
    d_items = torch.empty_like(items)
    for base in range(0, items.shape[0], chunk):
        c = items[base:base + chunk]
        z, ks = _chunk_z(u, c, base, valid_v, zero_row0)
        p = torch.exp(z - lse[:, None])
        if base + c.shape[0] > valid_v:
            p[:, max(valid_v - base, 0):] = 0.0
        if zero_row0 and base == 0:
            p[:, 0] = 0.0
        d_chunk = torch.zeros_like(c)
        for k in range(u.shape[1]):
            mk = p * (ks == k)
            du[:, k] += torch.matmul(mk, c)
            d_chunk += torch.matmul(mk.t(), u[:, k])
        d_items[base:base + c.shape[0]] = d_chunk
    return du, d_items


def check_inputs(u: torch.Tensor, items: torch.Tensor, valid_v: int) -> None:
    """Raise ValueError on inputs of the wrong structure."""
    if u.dim() != 3 or items.dim() != 2 or u.shape[2] != items.shape[1]:
        raise ValueError(f"u [B, K, D] and items [rows, D] expected, got {tuple(u.shape)} "
                         f"and {tuple(items.shape)}")
    if u.dtype != torch.float32 or items.dtype != torch.float32:
        raise ValueError(f"u and items must be float32, got {u.dtype} and {items.dtype}")
    if u.device != items.device:
        raise ValueError(f"u lies on {u.device}, items on {items.device}")
    if not 1 <= valid_v <= items.shape[0]:
        raise ValueError(f"valid_v must lie in [1, {items.shape[0]}], got {valid_v}")


def kernel_takes(K: int, D: int) -> bool:
    """Whether the kernels (K5f and K5b) take this shape."""
    return 1 <= K <= MAX_K and 1 <= D <= MAX_D


def routes_to_kernel(device: torch.device, K: int, D: int) -> bool:
    """True on the card for a shape the kernels take; False on the CPU, and
    on the card for a shape past the limits (counted in ``PLAIN_ROUTE``)."""
    global PLAIN_ROUTE
    if device.type != "cuda":
        return False
    if kernel_takes(K, D):
        return True
    PLAIN_ROUTE += 1
    return False


def check_supported(K: int, D: int) -> None:
    """Raise ValueError on a shape the kernels do not take."""
    if not kernel_takes(K, D):
        raise ValueError(f"the K-max CE kernels take 1 <= K <= {MAX_K} and 1 <= D <= {MAX_D}; "
                         f"got K={K}, D={D}")


def bind(lib):
    """((lse launch, its workspace words), (grads launch, its workspace
    words, the one-stage launch)) of a loaded ``multimax_ce`` library."""
    shape = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    plan = [ctypes.c_int, ctypes.c_int]
    lse = lib.rp_multimax_lse_f32
    lse.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + shape
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    lse.restype = ctypes.c_int
    grads = lib.rp_multimax_grads_f32
    grads.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + shape
                      + [ctypes.c_longlong, ctypes.c_int] + plan + [ctypes.c_void_p])
    grads.restype = ctypes.c_int
    stage = lib.rp_multimax_grads_stage_f32
    stage.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + shape
                      + [ctypes.c_longlong, ctypes.c_int] + plan + [ctypes.c_int] * 3
                      + [ctypes.c_void_p])
    stage.restype = ctypes.c_int
    lse_words = lib.rp_multimax_lse_workspace_words
    lse_words.argtypes = shape
    lse_words.restype = ctypes.c_longlong
    grads_words = lib.rp_multimax_grads_workspace_words
    grads_words.argtypes = shape + plan
    grads_words.restype = ctypes.c_longlong
    return (lse, lse_words), (grads, grads_words, stage)


def _functions():
    """``bind`` of the package's library, built at first use."""
    global _LSE_FN, _GRADS_FN
    if _LSE_FN is None:
        from . import _build

        _LSE_FN, _GRADS_FN = bind(_build.load("multimax_ce"))
    return _LSE_FN, _GRADS_FN


def _checked(u: torch.Tensor, items: torch.Tensor) -> Tuple[int, int, int, int]:
    B, K, D = u.shape
    check_supported(K, D)
    if not (u.is_contiguous() and items.is_contiguous()):
        raise ValueError("the K-max CE kernels take contiguous u and items")
    return B, K, D, items.shape[0]


def launch_lse(u: torch.Tensor, items: torch.Tensor, valid_v: int,
               zero_row0: bool) -> torch.Tensor:
    """K5f on checked CUDA inputs: lse [B]."""
    global LAUNCHES
    B, K, D, rows = _checked(u, items)
    lse = torch.empty(B, dtype=torch.float32, device=u.device)
    if B == 0:
        return lse
    (fn, words), _ = _functions()
    work = torch.empty(words(B, K, D, rows), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), items.data_ptr(), lse.data_ptr(), work.data_ptr(), work.numel(),
                 B, K, D, rows, int(valid_v), int(bool(zero_row0)), stream)
    if err != 0:
        raise RuntimeError(f"multimax_ce forward kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return lse


def launch_grads(u: torch.Tensor, items: torch.Tensor, lse: torch.Tensor, valid_v: int,
                 zero_row0: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5b on checked CUDA inputs: (du [B, K, D], d_items [rows, D])."""
    global BACKWARD_LAUNCHES
    B, K, D, rows = _checked(u, items)
    lse = lse.to(torch.float32).contiguous()
    du = torch.empty_like(u)
    d_items = torch.empty_like(items)
    if B == 0:
        return du, d_items.zero_()
    _, (fn, _, _) = _functions()
    plan = grads_plan(B, K, D, rows)
    work = torch.empty(plan.words, dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), items.data_ptr(), lse.data_ptr(), du.data_ptr(),
                 d_items.data_ptr(), work.data_ptr(), work.numel(), B, K, D, rows, int(valid_v),
                 int(bool(zero_row0)), plan.chunk_tiles, plan.tiles_per_split, stream)
    if err != 0:
        raise RuntimeError(f"multimax_ce backward kernel launch failed: CUDA error {err}")
    BACKWARD_LAUNCHES += 1
    return du, d_items


def workspace_views(work: torch.Tensor, B: int, K: int, D: int, plan: GradsPlan):
    """(p [B, chunk] f32, k* [B, chunk] u8, partial du [splits, B, K, D])
    in the backward's workspace ``work``."""
    pairs = B * plan.chunk_items
    p = work[:pairs].view(B, plan.chunk_items)
    ks = work[pairs:pairs + pairs // 4].view(torch.uint8).view(B, plan.chunk_items)
    partial = work[pairs + pairs // 4:plan.words].view(plan.splits, B, K, D)
    return p, ks, partial


def launch_grads_stage(u: torch.Tensor, items: torch.Tensor, lse: torch.Tensor, valid_v: int,
                       zero_row0: bool, plan: GradsPlan, work: torch.Tensor, chunk: int,
                       stage: int, out: Optional[torch.Tensor] = None,
                       accumulate: bool = False) -> None:
    """One launch of K5b, for checks and timing: ``stage`` 0 is P of chunk
    ``chunk`` (p and k* into ``work``), 1 is U (the splits' partial du into
    ``work``), 2 is S (``out`` du [B, K, D] = the chunk's partials summed in
    order, added to ``out`` when ``accumulate``), 3 is D (``out`` d_items
    [rows, D], the chunk's rows).  Not counted in ``BACKWARD_LAUNCHES``."""
    B, K, D, rows = _checked(u, items)
    if work.numel() < plan.words:
        raise ValueError(f"the workspace holds {work.numel()} words, the plan needs {plan.words}")
    _, (_, _, fn) = _functions()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), items.data_ptr(), lse.data_ptr(),
                 0 if out is None else out.data_ptr(), work.data_ptr(), work.numel(), B, K, D,
                 rows, int(valid_v), int(bool(zero_row0)), plan.chunk_tiles,
                 plan.tiles_per_split, chunk, stage, int(bool(accumulate)), stream)
    if err != 0:
        raise RuntimeError(f"multimax_ce backward stage {stage} launch failed: CUDA error {err}")


def multimax_lse(u: torch.Tensor, items: torch.Tensor, valid_v: int,
                 zero_row0: bool = False) -> torch.Tensor:
    """lse [B] of ``max_k u[b, k] . items[v]`` over ``v < valid_v``: K5f on
    the card for a shape it takes, else the plain version."""
    check_inputs(u, items, valid_v)
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no K-max CE kernel for device {u.device}")
    if not routes_to_kernel(u.device, u.shape[1], u.shape[2]):
        return multimax_lse_reference(u, items, valid_v, zero_row0)
    return launch_lse(u, items, valid_v, zero_row0)


def multimax_grads(u: torch.Tensor, items: torch.Tensor, lse: torch.Tensor, valid_v: int,
                   zero_row0: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(du [B, K, D], d_items [rows, D]): the softmax term of the K-max CE's
    gradient, unscaled; K5b on the card for a shape it takes (K5f's route),
    else the plain version."""
    check_inputs(u, items, valid_v)
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no K-max CE kernel for device {u.device}")
    if not routes_to_kernel(u.device, u.shape[1], u.shape[2]):
        return multimax_grads_reference(u, items, lse, valid_v, zero_row0)
    return launch_grads(u, items, lse, valid_v, zero_row0)
