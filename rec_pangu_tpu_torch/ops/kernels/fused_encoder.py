"""Fused post-LN transformer-encoder forward: the whole stack in one launch.

Replaces the JAX package's K4f (``rec_pangu_tpu/ops/kernels/fused_encoder.py``:
``_fwd_kernel``, reached through ``_pack_call`` and ``fused_encoder``).  For
x ``[N, L, D]`` and each of the stacked blocks: q/k/v projections; per head
``softmax((q_h k_h^T) / sqrt(dh) + mask) v_h`` with the additive mask 0 where
``key_valid[n, j] & (not causal or j <= l)`` and -1e6 elsewhere; the output
projection, a residual and LayerNorm; an FFN (relu, gelu in its tanh form, or
swish), a residual and LayerNorm.

The CUDA kernel (``rec_pangu_tpu_torch/csrc/fused_encoder.cu``) is one
kernel body for serving and for training: each sample gets one thread block
that keeps its activations in shared memory through every layer, so only x
and y (and in training the saved activations) cross device memory.  Each
layer's weights stream through shared memory in chunks copied by
``cp.async``, and every value is the float32 fmaf chain of the kernel's
earlier versions, bit for bit (the backward's gates hold only those bits).
Bound: operations, about 5.5 GFLOP at SASRec's bench shape (N=1024, L=50,
D=64, 4 heads, inner 32, 2 layers), 0.082 ms at the H100 SXM's 67 TFLOP/s
float32 rate.  ``launch_plan`` is the launch's shape (threads and shared
memory a block), computed as the kernel computes it.  The TPU kernel's tile
of 4 samples, its lane-masked heads and its block-diagonal ``[TB*L, TB*L]``
scores fed the TPU's matrix unit; none of it carries over, and N need not
be a multiple of anything.

A query row with no valid key (an empty history) is softmaxed over its own
sample's L keys, each score minus 1e6 in float32, as the flax path does; the
TPU kernel spreads such a row over the other samples of its tile.

The weights are packed as the JAX package's ``pack_params`` packs them
(flax ``[in, out]`` kernels): wqkvo ``[layers, 4, D, D]``, bqkvo
``[layers, 4, D]``, w1 ``[layers, D, inner]``, b1 ``[layers, inner]``, w2
``[layers, inner, D]``, b2 ``[layers, D]``, ln_g and ln_b ``[layers, 2, D]``.

Training (``train=True``) adds inverted dropout at the flax block's three
places (the attention probabilities, the output projection and the FFN
output, each before it is used or added to its residual) and a backward.  On
the card the forward is the same kernel in training mode, which also keeps
the activations the backward needs (about 0.11 MB a sample and layer at the
bench shape), and autograd's backward is
K4b (``_bwd_kernel``): from the last layer to the first, three launches over
the whole batch (the rows' LayerNorm and FFN part, the attention a sample at
a time, the weight gradients over fixed chunks of rows), then the chunks'
partial sums added in a fixed order (no atomics: the same bits every run);
``encoder_bwd.py`` has each stage and its plain version.  The dropout masks are
a counter-based hash of (seed, sample, layer, site, element) that the
kernels and ``dropout_scale`` below compute alike, so the card and the CPU
draw the same masks for a seed; the TPU kernel's on-chip bits cannot be
matched.  An element is kept when its 32-bit draw is at least
``min(floor(p * 2**32), 2**32 - 1)`` and then scaled by ``1 / (1 - p)``
(float32).

The wrapper chooses its route by the shape before it launches anything, as
the JAX package's gate does (``routes_to_kernel``): CUDA tensors of a shape
the kernels take (``kernel_takes``: L <= ``MAX_L``, D <= ``MAX_D``, inner <=
4 D) launch them, and raise if a launch fails; other shapes on the card, and
tensors on the CPU, run the plain version below (the card's such calls count
in ``PLAIN_ROUTE``).  The inference call (no gradient, no dropout) is the
forward kernel alone, as before.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

# kernel launches so far (the forward, in inference or training mode; the
# backward); a run resets them and reads them to show the path went through
# the kernels
LAUNCHES = 0
BACKWARD_LAUNCHES = 0
# calls on the card that took the plain version because the shape lies past
# the kernels' limits (``kernel_takes``)
PLAIN_ROUTE = 0

ACTIVATIONS = {"relu": 0, "gelu": 1, "swish": 2, "silu": 2}
MAX_L = 64    # eight lanes hold a row of scores, eight keys a lane
MAX_D = 128   # a warp holds a LayerNorm row, four columns a lane
PACKED_NAMES = ("wqkvo", "bqkvo", "w1", "b1", "w2", "b2", "ln_g", "ln_b")
_NEG = -1e6
_MASK32 = 0xFFFFFFFF
# dropout sites, as the kernel numbers them
ATTN_SITE, ATTN_OUT_SITE, FFN_OUT_SITE = 0, 1, 2

_FN = None
_TRAIN_FN = None
_BWD_FN = None


def _activate(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(h)
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    return F.silu(h)


def additive_mask(key_valid: torch.Tensor, causal: bool) -> torch.Tensor:
    """[N, L] key validity -> [N, 1, L, L] float32: 0 where query l may see
    key j, -1e6 elsewhere."""
    L = key_valid.shape[1]
    ok = (key_valid != 0)[:, None, None, :]
    if causal:
        ok = ok & torch.ones(L, L, dtype=torch.bool, device=key_valid.device).tril()
    return torch.where(ok, 0.0, _NEG).to(torch.float32)


def attention_scores(q: torch.Tensor, k: torch.Tensor, add_mask: torch.Tensor) -> torch.Tensor:
    """[N, L, H, dh] q and k -> [N, H, L, L] masked scores, divided by
    sqrt(dh) in float32 before the mask is added (the flax path's order)."""
    sqrt_dh = float(np.sqrt(np.float32(q.shape[-1])))
    return torch.einsum("blhd,bmhd->bhlm", q, k) / sqrt_dh + add_mask


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    return ((x & 0xFFFF) * c + (((x >> 16) * (c & 0xFFFF)) << 16)) & _MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The kernel's 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def drop_threshold(rate: float) -> int:
    """An element is kept when its draw is at least this."""
    return min(int(rate * 2.0 ** 32), _MASK32)


def drop_scale(rate: float) -> float:
    """1 / (1 - p) in float32, the value of a kept element's factor."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"a dropout rate must lie in [0, 1), got {rate}")


def dropout_scale(seed: int, n: int, layer: int, site: int, shape: Sequence[int], rate: float,
                  device=None, first: int = 0) -> torch.Tensor:
    """The kernels' dropout factors [n, *shape] float32 (0 dropped, 1/(1-p)
    kept) for samples first..first+n-1 of one layer and site: element i of
    sample s (row-major in ``shape``: (h, l, j) of the attention
    probabilities, (l, c) of a hidden site) draws mix(key ^ mix(i)) with key
    = mix(mix(mix(seed ^ 0x9e3779b9) ^ s) ^ (3 * layer + site))."""
    base = int(mix32(torch.tensor([(int(seed) & _MASK32) ^ 0x9E3779B9], dtype=torch.int64))[0])
    samples = torch.arange(first, first + n, dtype=torch.int64, device=device)
    key = mix32(mix32(samples ^ base) ^ (3 * layer + site))
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device)
    draw = mix32(key[:, None] ^ mix32(idx)[None, :])
    keep = draw >= drop_threshold(rate)
    return (keep.to(torch.float32) * drop_scale(rate)).view(n, *shape)


def fused_encoder_reference(x: torch.Tensor, key_valid: torch.Tensor,
                            packed: Sequence[torch.Tensor], n_heads: int,
                            causal: bool = True, act: str = "relu",
                            eps: float = 1e-12, train: bool = False,
                            hidden_dropout: float = 0.0, attn_dropout: float = 0.0,
                            seed: int = 0, first: int = 0) -> torch.Tensor:
    """Plain PyTorch version over the packed weights: [N, L, D] -> [N, L, D];
    with ``train``, the kernels' dropout masks (``dropout_scale``), sample i
    with row ``first + i``'s."""
    wqkvo, bqkvo, w1, b1, w2, b2, ln_g, ln_b = packed
    N, L, D = x.shape
    heads = (N, L, n_heads, D // n_heads)
    add_mask = additive_mask(key_valid, causal)
    for li in range(wqkvo.shape[0]):
        masks = layer_masks(seed, N, li, L, D, n_heads, hidden_dropout if train else 0.0,
                            attn_dropout if train else 0.0, x.device, first)
        q, k, v = (torch.matmul(x, wqkvo[li, i]) + bqkvo[li, i] for i in range(3))
        probs = torch.softmax(attention_scores(q.view(heads), k.view(heads), add_mask), dim=-1)
        if masks[ATTN_SITE] is not None:
            probs = probs * masks[ATTN_SITE]
        ctx = torch.einsum("bhlm,bmhd->blhd", probs, v.view(heads)).reshape(N, L, D)
        a = torch.matmul(ctx, wqkvo[li, 3]) + bqkvo[li, 3]
        if masks[ATTN_OUT_SITE] is not None:
            a = a * masks[ATTN_OUT_SITE]
        x1 = F.layer_norm(a + x, (D,), ln_g[li, 0], ln_b[li, 0], eps)
        h = _activate(torch.matmul(x1, w1[li]) + b1[li], act)
        f = torch.matmul(h, w2[li]) + b2[li]
        if masks[FFN_OUT_SITE] is not None:
            f = f * masks[FFN_OUT_SITE]
        x = F.layer_norm(f + x1, (D,), ln_g[li, 1], ln_b[li, 1], eps)
    return x


def layer_masks(seed: int, n: int, layer: int, L: int, D: int, n_heads: int,
                hidden_dropout: float, attn_dropout: float, device=None,
                first: int = 0) -> tuple:
    """One layer's dropout factors by site (None where the rate is 0) of
    samples first..first+n-1: the attention probabilities [n, heads, L, L],
    the attention output and the FFN output [n, L, D]."""
    attn = (dropout_scale(seed, n, layer, ATTN_SITE, (n_heads, L, L), attn_dropout, device,
                          first) if attn_dropout > 0 else None)
    hidden = [dropout_scale(seed, n, layer, site, (L, D), hidden_dropout, device, first)
              if hidden_dropout > 0 else None for site in (ATTN_OUT_SITE, FFN_OUT_SITE)]
    return (attn, *hidden)


def check_inputs(x: torch.Tensor, key_valid: torch.Tensor, packed: Sequence[torch.Tensor],
                 n_heads: int, act: str) -> None:
    """Raise ValueError on inputs of the wrong structure."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 [N, L, D], got {tuple(x.shape)} {x.dtype}")
    N, L, D = x.shape
    if tuple(key_valid.shape) != (N, L):
        raise ValueError(f"key_valid must be [{N}, {L}], got {tuple(key_valid.shape)}")
    if act not in ACTIVATIONS:
        raise ValueError(f"activation {act!r} is not one of {sorted(ACTIVATIONS)}")
    if n_heads <= 0 or D % n_heads:
        raise ValueError(f"D={D} is not divisible by n_heads={n_heads}")
    if len(packed) != len(PACKED_NAMES):
        raise ValueError(f"packed weights must be the {len(PACKED_NAMES)} arrays "
                         f"{PACKED_NAMES}, got {len(packed)}")
    layers, inner = packed[0].shape[0], packed[2].shape[-1]
    want = ((layers, 4, D, D), (layers, 4, D), (layers, D, inner), (layers, inner),
            (layers, inner, D), (layers, D), (layers, 2, D), (layers, 2, D))
    for name, t, shape in zip(PACKED_NAMES, packed, want):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {list(shape)}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    if key_valid.device != x.device:
        raise ValueError(f"key_valid lies on {key_valid.device}, x on {x.device}")


def _pad_ld(k: int) -> int:
    """The kernel's row stride for k columns in shared memory (pad_ld)."""
    k4 = (k + 3) // 4 * 4
    return k4 + (4 if (k4 // 4) % 2 == 0 else 8)


class LaunchPlan(NamedTuple):
    samples: int       # samples a block
    threads: int       # threads a block
    smem_bytes: int    # dynamic shared memory a block
    heads: int         # heads an attention pass holds scores for


SMEM_LIMIT = 232_448  # shared memory one block may use on the H100
SMEM_TWO = 115_712    # ... with two blocks on an SM (228 KB, 1 KB a block reserved)
RING = 2              # weight chunks in the kernel's ring (kRing)
CHUNK = 64            # weight rows of a chunk (kFwdChunk), 64 columns


def launch_plan(L: int, D: int, inner: int, heads: int) -> LaunchPlan:
    """K4f's launch for rows of L x D, FFN width inner and ``heads`` heads,
    as the kernel computes it (``fwd_threads``, ``fwd_layout``;
    ``rp_fused_encoder_plan`` returns the same): one sample a block, 16
    threads per 4-row tile in whole warps; shared memory for x, q, k and v
    (the FFN's hidden rows over q..v), the scores of as many heads as leave
    two blocks an SM where that is possible (else as fit one block, at
    least one), the weight ring of RING CHUNK x 64 chunks and the keys'
    validity."""
    check_supported(L, D, inner, 1)
    if heads <= 0 or D % heads:
        raise ValueError(f"D={D} is not divisible by n_heads={heads}")
    threads = (16 * ((L + 3) // 4) + 31) // 32 * 32
    ld, ldp = _pad_ld(D), (L + 3) // 4 * 4
    probs = L * ld + L * max(3 * ld, _pad_ld(inner))
    rest = RING * CHUNK * 64 + ldp
    base, head = 4 * (probs + rest), 4 * L * ldp
    budget = SMEM_TWO if base + head <= SMEM_TWO else SMEM_LIMIT
    hb = max(1, min(heads, (budget - base) // head))
    return LaunchPlan(1, threads, base + hb * head, hb)


def kernel_launch_plan(L: int, D: int, inner: int, heads: int) -> LaunchPlan:
    """The library's own plan (``rp_fused_encoder_plan``), for holding
    launch_plan to it on the card."""
    fn = _build.load("fused_encoder").rp_fused_encoder_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    if fn(L, D, inner, heads, out) != 0:
        raise ValueError(f"the kernel refuses L={L}, D={D}, inner={inner}, heads={heads}")
    return LaunchPlan(*out)


def kernel_takes(L: int, D: int, inner: int, layers: int = 1) -> bool:
    """Whether the kernels (K4f and K4b) take this shape: L <= ``MAX_L``,
    D <= ``MAX_D``, inner <= 4 D (the JAX package gates its kernel by shape
    too and runs other shapes on XLA)."""
    return 1 <= L <= MAX_L and 1 <= D <= MAX_D and 1 <= inner <= 4 * D and layers >= 1


def routes_to_kernel(device: torch.device, L: int, D: int, inner: int, layers: int) -> bool:
    """The route of a call, decided on the shape before any launch: True on
    the card for a shape the kernels take; False on the CPU, and on the card
    for a shape past the limits, which runs the plain version and counts in
    ``PLAIN_ROUTE``.  Not a fallback: a kernel that fails still raises."""
    global PLAIN_ROUTE
    if device.type != "cuda":
        return False
    if kernel_takes(L, D, inner, layers):
        return True
    PLAIN_ROUTE += 1
    return False


def check_supported(L: int, D: int, inner: int, layers: int) -> None:
    """Raise ValueError on a shape the kernel does not take."""
    if not kernel_takes(L, D, inner, layers):
        raise ValueError(f"the fused encoder kernel takes 1 <= L <= {MAX_L}, "
                         f"1 <= D <= {MAX_D}, 1 <= inner <= 4 D and >= 1 layer; got "
                         f"L={L}, D={D}, inner={inner}, layers={layers}")


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("fused_encoder").rp_fused_encoder_f32
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch(x: torch.Tensor, key_valid: torch.Tensor, packed: Sequence[torch.Tensor],
           n_heads: int, causal: bool, act: str, eps: float) -> torch.Tensor:
    """One kernel launch on checked CUDA inputs."""
    global LAUNCHES
    N, L, D = x.shape
    layers, inner = packed[0].shape[0], packed[2].shape[-1]
    check_supported(L, D, inner, layers)
    kv = key_valid.to(torch.float32).contiguous()
    if not (x.is_contiguous() and all(t.is_contiguous() for t in packed)):
        raise ValueError("the fused encoder kernel takes contiguous x and weights")
    y = torch.empty_like(x)
    if N == 0:
        return y
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), kv.data_ptr(), *(t.data_ptr() for t in packed), y.data_ptr(),
                 N, L, D, layers, n_heads, inner, int(bool(causal)), ACTIVATIONS[act],
                 float(eps), stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y


_DROP_ARGS = [ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_float,
              ctypes.c_int, ctypes.c_int, ctypes.c_uint]


def _train_kernel():
    global _TRAIN_FN
    if _TRAIN_FN is None:
        fn = _build.load("fused_encoder").rp_fused_encoder_train_f32
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                       + [ctypes.c_float] + _DROP_ARGS + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _TRAIN_FN = fn
    return _TRAIN_FN


def _bwd_kernel():
    """(the launch, its workspace size in 4-byte words) from the library."""
    global _BWD_FN
    if _BWD_FN is None:
        lib = _build.load("fused_encoder")
        fn = lib.rp_fused_encoder_bwd_f32
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_longlong, ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_float] + _DROP_ARGS
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        words = lib.rp_fused_encoder_bwd_workspace_words
        words.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 4
        words.restype = ctypes.c_longlong
        _BWD_FN = fn, words
    return _BWD_FN


def _dropout_args(seed: int, hidden_dropout: float, attn_dropout: float,
                  first: int = 0) -> tuple:
    return (int(seed) & _MASK32, drop_threshold(hidden_dropout), drop_threshold(attn_dropout),
            drop_scale(hidden_dropout), drop_scale(attn_dropout), int(hidden_dropout > 0),
            int(attn_dropout > 0), int(first) & _MASK32)


def _shape_args(x, packed, n_heads, causal, act, eps) -> tuple:
    N, L, D = x.shape
    layers, inner = packed[0].shape[0], packed[2].shape[-1]
    check_supported(L, D, inner, layers)
    if not (x.is_contiguous() and all(t.is_contiguous() for t in packed)):
        raise ValueError("the fused encoder kernels take contiguous x and weights")
    return (N, L, D, layers, n_heads, inner, int(bool(causal)), ACTIVATIONS[act], float(eps))


def saved_floats(rows: int, D: int, inner: int) -> int:
    """Floats of one layer's saved activations over ``rows = N * L`` rows
    (``encoder_bwd.saved_views``)."""
    return rows * (8 * D + inner + 2)


def launch_train(x: torch.Tensor, key_valid: torch.Tensor, packed: Sequence[torch.Tensor],
                 n_heads: int, causal: bool, act: str, eps: float, hidden_dropout: float,
                 attn_dropout: float, seed: int, save: bool, first: int = 0):
    """One launch of the training forward on checked CUDA inputs: (y, the
    activations K4b reads [layers, saved_floats] when ``save``, else None);
    sample i draws the dropout masks of row ``first + i``."""
    global LAUNCHES
    shape = _shape_args(x, packed, n_heads, causal, act, eps)
    N, L, D, layers, inner = shape[0], shape[1], shape[2], shape[3], shape[5]
    kv = key_valid.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    saved = x.new_empty(layers, saved_floats(N * L, D, inner)) if save else None
    if N == 0:
        return y, saved
    fn = _train_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), kv.data_ptr(), *(t.data_ptr() for t in packed), y.data_ptr(),
                 saved.data_ptr() if save else None, *shape,
                 *_dropout_args(seed, hidden_dropout, attn_dropout, first), stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder training kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y, saved


def launch_backward(saved: torch.Tensor, key_valid: torch.Tensor, dy: torch.Tensor,
                    packed: Sequence[torch.Tensor], n_heads: int, causal: bool, act: str,
                    eps: float, hidden_dropout: float, attn_dropout: float, seed: int,
                    first: int = 0):
    """K4b on CUDA inputs, from the training forward's ``saved``: (dx [N, L,
    D], the 8 packed arrays' gradients); ``first`` as ``launch_train``'s."""
    global BACKWARD_LAUNCHES
    dy = dy.to(torch.float32).contiguous()
    shape = _shape_args(dy, packed, n_heads, causal, act, eps)
    N, L, D, layers, inner = shape[0], shape[1], shape[2], shape[3], shape[5]
    if saved.shape != (layers, saved_floats(N * L, D, inner)) or not saved.is_contiguous():
        raise ValueError(f"saved must be the training forward's contiguous [{layers}, "
                         f"{saved_floats(N * L, D, inner)}], got {tuple(saved.shape)}")
    kv = key_valid.to(torch.float32).contiguous()
    dx = torch.empty_like(dy)
    grads = torch.empty(sum(t.numel() for t in packed), dtype=torch.float32, device=dy.device)
    if N == 0:
        grads.zero_()
    else:
        fn, words = _bwd_kernel()
        work = torch.empty(words(N, L, D, layers, inner), dtype=torch.float32, device=dy.device)
        with torch.cuda.device(dy.device):
            stream = torch.cuda.current_stream(dy.device).cuda_stream
            err = fn(saved.data_ptr(), kv.data_ptr(), dy.data_ptr(),
                     *(t.data_ptr() for t in packed), dx.data_ptr(), grads.data_ptr(),
                     work.data_ptr(), work.numel(), *shape,
                     *_dropout_args(seed, hidden_dropout, attn_dropout, first), stream)
        if err != 0:
            raise RuntimeError(f"fused_encoder backward kernel launch failed: CUDA error {err}")
        BACKWARD_LAUNCHES += 1
    return dx, tuple(g.view(t.shape) for g, t in
                     zip(grads.split([t.numel() for t in packed]), packed))


class _TrainingEncoder(torch.autograd.Function):
    """The training forward kernel; its backward is K4b."""

    @staticmethod
    def forward(ctx, x, key_valid, options, first, *packed):
        y, saved = launch_train(x, key_valid, packed, *options,
                                save=any(ctx.needs_input_grad), first=first)
        ctx.options, ctx.first = options, first
        if saved is not None:
            ctx.save_for_backward(saved, key_valid, *packed)
        return y

    @staticmethod
    def backward(ctx, dy):
        saved, key_valid, *packed = ctx.saved_tensors
        dx, grads = launch_backward(saved, key_valid, dy, packed, *ctx.options,
                                    first=ctx.first)
        return (dx, None, None, None, *grads)


def fused_encoder(x: torch.Tensor, key_valid: torch.Tensor, packed: Sequence[torch.Tensor],
                  n_heads: int, causal: bool = True, act: str = "relu",
                  eps: float = 1e-12, train: bool = False, hidden_dropout: float = 0.0,
                  attn_dropout: float = 0.0, seed: int = 0, first: int = 0) -> torch.Tensor:
    """x [N, L, D] f32, key_valid [N, L] (nonzero = valid key), the 8 packed
    weight arrays -> y [N, L, D]: the kernels on the card for a shape they
    take (``kernel_takes``), else the plain version.  ``train`` applies
    dropout at the given rates with the masks of ``seed``, sample i with row
    ``first + i``'s (a data-parallel block's first global row; the JAX
    package's ``fused_encoder_dp`` folds the shard index into the seed
    instead); on the card, a call autograd may differentiate runs the
    training kernel, whose backward is K4b."""
    check_inputs(x, key_valid, packed, n_heads, act)
    check_rate(hidden_dropout)
    check_rate(attn_dropout)
    if not train:
        hidden_dropout = attn_dropout = 0.0
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused encoder kernel for device {x.device}")
    layers, _, inner = packed[2].shape
    if not routes_to_kernel(x.device, x.shape[1], x.shape[2], inner, layers):
        return fused_encoder_reference(x, key_valid, packed, n_heads, causal, act, eps, train,
                                       hidden_dropout, attn_dropout, seed, first)
    wants_grad = torch.is_grad_enabled() and (x.requires_grad
                                              or any(t.requires_grad for t in packed))
    if not wants_grad and hidden_dropout == 0.0 and attn_dropout == 0.0:
        return launch(x, key_valid, packed, n_heads, causal, act, eps)
    options = (n_heads, causal, act, eps, hidden_dropout, attn_dropout, seed)
    return _TrainingEncoder.apply(x, key_valid, options, first, *packed)
