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
the ``[B, K, V]`` logits: the forward keeps each block's running (max, sum)
over its range of item tiles and combines the ranges in order; the backward
is one launch that owns ``d_items`` tiles and one that owns ranges of ``du``,
both recomputing z and k*, summed in a fixed order (no atomics).  Bound:
operations, ``2 B K D V`` FLOP forward and three times that backward.  The
wrappers launch them for CUDA tensors and raise if they cannot (``K`` past
``MAX_K`` or ``D`` past ``MAX_D`` is a ``ValueError``); the plain versions
below, the chunked form of the JAX package's scan, serve tensors on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

LAUNCHES = 0           # forward launches (K5f)
BACKWARD_LAUNCHES = 0  # backward launches (K5b)

MAX_K = 4     # interests: a thread holds 2 users x K x 8 items of logits
MAX_D = 128
CHUNK = 131_072  # items a chunk of the plain versions
_NEG = -1e30     # a finite -inf: exp gives exactly 0

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


def check_supported(K: int, D: int) -> None:
    """Raise ValueError on a shape the kernels do not take."""
    if not (1 <= K <= MAX_K and 1 <= D <= MAX_D):
        raise ValueError(f"the K-max CE kernels take 1 <= K <= {MAX_K} and 1 <= D <= {MAX_D}; "
                         f"got K={K}, D={D}")


def _functions():
    """((lse launch, its workspace words), (grads launch, its workspace words))."""
    global _LSE_FN, _GRADS_FN
    if _LSE_FN is None:
        from . import _build

        lib = _build.load("multimax_ce")
        shape = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
        lse = lib.rp_multimax_lse_f32
        lse.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + shape
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        lse.restype = ctypes.c_int
        grads = lib.rp_multimax_grads_f32
        grads.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + shape
                          + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        grads.restype = ctypes.c_int
        words = []
        for name in ("rp_multimax_lse_workspace_words", "rp_multimax_grads_workspace_words"):
            fn = getattr(lib, name)
            fn.argtypes = shape
            fn.restype = ctypes.c_longlong
            words.append(fn)
        _LSE_FN, _GRADS_FN = (lse, words[0]), (grads, words[1])
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
    _, (fn, words) = _functions()
    work = torch.empty(words(B, K, D, rows), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), items.data_ptr(), lse.data_ptr(), du.data_ptr(),
                 d_items.data_ptr(), work.data_ptr(), work.numel(), B, K, D, rows, int(valid_v),
                 int(bool(zero_row0)), stream)
    if err != 0:
        raise RuntimeError(f"multimax_ce backward kernel launch failed: CUDA error {err}")
    BACKWARD_LAUNCHES += 1
    return du, d_items


def multimax_lse(u: torch.Tensor, items: torch.Tensor, valid_v: int,
                 zero_row0: bool = False) -> torch.Tensor:
    """lse [B] of ``max_k u[b, k] . items[v]`` over ``v < valid_v``: K5f on
    the card, the plain version on the CPU."""
    check_inputs(u, items, valid_v)
    if u.device.type == "cpu":
        return multimax_lse_reference(u, items, valid_v, zero_row0)
    if u.device.type != "cuda":
        raise ValueError(f"no K-max CE kernel for device {u.device}")
    return launch_lse(u, items, valid_v, zero_row0)


def multimax_grads(u: torch.Tensor, items: torch.Tensor, lse: torch.Tensor, valid_v: int,
                   zero_row0: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(du [B, K, D], d_items [rows, D]): the softmax term of the K-max CE's
    gradient, unscaled; K5b on the card, the plain version on the CPU."""
    check_inputs(u, items, valid_v)
    if u.device.type == "cpu":
        return multimax_grads_reference(u, items, lse, valid_v, zero_row0)
    if u.device.type != "cuda":
        raise ValueError(f"no K-max CE kernel for device {u.device}")
    return launch_grads(u, items, lse, valid_v, zero_row0)
