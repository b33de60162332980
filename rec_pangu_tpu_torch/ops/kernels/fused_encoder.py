"""Fused post-LN transformer-encoder forward: the whole stack in one launch.

Replaces the JAX package's K4f (``rec_pangu_tpu/ops/kernels/fused_encoder.py``:
``_fwd_kernel``, reached through ``_pack_call`` and ``fused_encoder``).  For
x ``[N, L, D]`` and each of the stacked blocks: q/k/v projections; per head
``softmax((q_h k_h^T) / sqrt(dh) + mask) v_h`` with the additive mask 0 where
``key_valid[n, j] & (not causal or j <= l)`` and -1e6 elsewhere; the output
projection, a residual and LayerNorm; an FFN (relu, gelu in its tanh form, or
swish), a residual and LayerNorm.

The CUDA kernel (``rec_pangu_tpu_torch/csrc/fused_encoder.cu``) gives each
sample one thread block that keeps its activations in shared memory through
every layer, so only x and y cross device memory; it is float32 on CUDA
cores.  Bound: operations, about 5.5 GFLOP at the bench shape (N=1024, L=50,
D=64, 4 heads, inner 32, 2 layers), 0.082 ms at the H100 SXM's 67 TFLOP/s
float32 rate.  The TPU kernel's tile of 4 samples, its lane-masked heads and
its block-diagonal ``[TB*L, TB*L]`` scores fed the TPU's matrix unit; none
of it carries over, and N need not be a multiple of anything.

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
the card the forward is the training kernel of the same source (K4f in
training mode), which also keeps each layer's input, and autograd's backward
is K4b (``_bwd_kernel``): per sample and layer it recomputes the layer from
its input and runs the layer's backward, summing the parameter gradients in
a fixed order (no atomics: the same bits every run).  The dropout masks are
a counter-based hash of (seed, sample, layer, site, element) that the
kernels and ``dropout_scale`` below compute alike, so the card and the CPU
draw the same masks for a seed; the TPU kernel's on-chip bits cannot be
matched.  An element is kept when its 32-bit draw is at least
``min(floor(p * 2**32), 2**32 - 1)`` and then scaled by ``1 / (1 - p)``
(float32).

The wrapper launches the kernels for CUDA tensors and raises if it cannot
(a shape outside ``MAX_L``/``MAX_D``/``inner <= 4 D`` is a ``ValueError``);
it uses the plain version below only for tensors on the CPU.  The inference
call (no gradient, no dropout) is the forward kernel alone, as before.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

# kernel launches so far (the forward, in inference or training mode; the
# backward); a run resets them and reads them to show the path went through
# the kernels
LAUNCHES = 0
BACKWARD_LAUNCHES = 0

ACTIVATIONS = {"relu": 0, "gelu": 1, "swish": 2, "silu": 2}
MAX_L = 64    # a warp holds one row of scores, two keys a lane
MAX_D = 128   # five [L, D + 1] float buffers stay within a block's shared memory
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
                  device=None) -> torch.Tensor:
    """The kernels' dropout factors [n, *shape] float32 (0 dropped, 1/(1-p)
    kept) for samples 0..n-1 of one layer and site: element i of sample s
    (row-major in ``shape``: (h, l, j) of the attention probabilities, (l, c)
    of a hidden site) draws mix(key ^ mix(i)) with key = mix(mix(mix(seed ^
    0x9e3779b9) ^ s) ^ (3 * layer + site))."""
    base = int(mix32(torch.tensor([(int(seed) & _MASK32) ^ 0x9E3779B9], dtype=torch.int64))[0])
    samples = torch.arange(n, dtype=torch.int64, device=device)
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
                            seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version over the packed weights: [N, L, D] -> [N, L, D];
    with ``train``, the kernels' dropout masks (``dropout_scale``)."""
    wqkvo, bqkvo, w1, b1, w2, b2, ln_g, ln_b = packed
    N, L, D = x.shape
    heads = (N, L, n_heads, D // n_heads)
    add_mask = additive_mask(key_valid, causal)
    for li in range(wqkvo.shape[0]):
        masks = layer_masks(seed, N, li, L, D, n_heads, hidden_dropout if train else 0.0,
                            attn_dropout if train else 0.0, x.device)
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
                hidden_dropout: float, attn_dropout: float, device=None) -> tuple:
    """One layer's dropout factors by site (None where the rate is 0): the
    attention probabilities [n, heads, L, L], the attention output and the
    FFN output [n, L, D]."""
    attn = (dropout_scale(seed, n, layer, ATTN_SITE, (n_heads, L, L), attn_dropout, device)
            if attn_dropout > 0 else None)
    hidden = [dropout_scale(seed, n, layer, site, (L, D), hidden_dropout, device)
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


def check_supported(L: int, D: int, inner: int, layers: int) -> None:
    """Raise ValueError on a shape the kernel does not take."""
    if not (1 <= L <= MAX_L and 1 <= D <= MAX_D and 1 <= inner <= 4 * D and layers >= 1):
        raise ValueError(f"the fused encoder kernel takes 1 <= L <= {MAX_L}, "
                         f"1 <= D <= {MAX_D}, 1 <= inner <= 4 D and >= 1 layer; got "
                         f"L={L}, D={D}, inner={inner}, layers={layers}")


def _kernel():
    global _FN
    if _FN is None:
        from . import _build

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
              ctypes.c_int, ctypes.c_int]


def _train_kernel():
    global _TRAIN_FN
    if _TRAIN_FN is None:
        from . import _build

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
        from . import _build

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


def _dropout_args(seed: int, hidden_dropout: float, attn_dropout: float) -> tuple:
    return (int(seed) & _MASK32, drop_threshold(hidden_dropout), drop_threshold(attn_dropout),
            drop_scale(hidden_dropout), drop_scale(attn_dropout), int(hidden_dropout > 0),
            int(attn_dropout > 0))


def _shape_args(x, packed, n_heads, causal, act, eps) -> tuple:
    N, L, D = x.shape
    layers, inner = packed[0].shape[0], packed[2].shape[-1]
    check_supported(L, D, inner, layers)
    if not (x.is_contiguous() and all(t.is_contiguous() for t in packed)):
        raise ValueError("the fused encoder kernels take contiguous x and weights")
    return (N, L, D, layers, n_heads, inner, int(bool(causal)), ACTIVATIONS[act], float(eps))


def launch_train(x: torch.Tensor, key_valid: torch.Tensor, packed: Sequence[torch.Tensor],
                 n_heads: int, causal: bool, act: str, eps: float, hidden_dropout: float,
                 attn_dropout: float, seed: int, save: bool):
    """One launch of the training forward on checked CUDA inputs: (y, each
    layer's input [layers, N, L, D] when ``save``, else None)."""
    global LAUNCHES
    shape = _shape_args(x, packed, n_heads, causal, act, eps)
    N, layers = shape[0], shape[3]
    kv = key_valid.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    saved = x.new_empty((layers,) + tuple(x.shape)) if save else None
    if N == 0:
        return y, saved
    fn = _train_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), kv.data_ptr(), *(t.data_ptr() for t in packed), y.data_ptr(),
                 saved.data_ptr() if save else None, *shape,
                 *_dropout_args(seed, hidden_dropout, attn_dropout), stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder training kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y, saved


def launch_backward(saved: torch.Tensor, key_valid: torch.Tensor, dy: torch.Tensor,
                    packed: Sequence[torch.Tensor], n_heads: int, causal: bool, act: str,
                    eps: float, hidden_dropout: float, attn_dropout: float, seed: int):
    """K4b on CUDA inputs: (dx [N, L, D], the 8 packed arrays' gradients)."""
    global BACKWARD_LAUNCHES
    x = saved[0]
    shape = _shape_args(x, packed, n_heads, causal, act, eps)
    N, L, D, layers, inner = shape[0], shape[1], shape[2], shape[3], shape[5]
    kv = key_valid.to(torch.float32).contiguous()
    dy = dy.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    grads = torch.empty(sum(t.numel() for t in packed), dtype=torch.float32, device=x.device)
    if N == 0:
        grads.zero_()
    else:
        fn, words = _bwd_kernel()
        work = torch.empty(words(N, L, D, layers, inner), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(saved.data_ptr(), kv.data_ptr(), dy.data_ptr(),
                     *(t.data_ptr() for t in packed), dx.data_ptr(), grads.data_ptr(),
                     work.data_ptr(), work.numel(), *shape,
                     *_dropout_args(seed, hidden_dropout, attn_dropout), stream)
        if err != 0:
            raise RuntimeError(f"fused_encoder backward kernel launch failed: CUDA error {err}")
        BACKWARD_LAUNCHES += 1
    return dx, tuple(g.view(t.shape) for g, t in
                     zip(grads.split([t.numel() for t in packed]), packed))


class _TrainingEncoder(torch.autograd.Function):
    """The training forward kernel; its backward is K4b."""

    @staticmethod
    def forward(ctx, x, key_valid, options, *packed):
        y, saved = launch_train(x, key_valid, packed, *options,
                                save=any(ctx.needs_input_grad))
        ctx.options = options
        if saved is not None:
            ctx.save_for_backward(saved, key_valid, *packed)
        return y

    @staticmethod
    def backward(ctx, dy):
        saved, key_valid, *packed = ctx.saved_tensors
        dx, grads = launch_backward(saved, key_valid, dy, packed, *ctx.options)
        return (dx, None, None, *grads)


def fused_encoder(x: torch.Tensor, key_valid: torch.Tensor, packed: Sequence[torch.Tensor],
                  n_heads: int, causal: bool = True, act: str = "relu",
                  eps: float = 1e-12, train: bool = False, hidden_dropout: float = 0.0,
                  attn_dropout: float = 0.0, seed: int = 0) -> torch.Tensor:
    """x [N, L, D] f32, key_valid [N, L] (nonzero = valid key), the 8 packed
    weight arrays -> y [N, L, D]: the kernels on the card, the plain version
    on the CPU.  ``train`` applies dropout at the given rates with the masks
    of ``seed``; on the card, a call autograd may differentiate runs the
    training kernel, whose backward is K4b."""
    check_inputs(x, key_valid, packed, n_heads, act)
    check_rate(hidden_dropout)
    check_rate(attn_dropout)
    if not train:
        hidden_dropout = attn_dropout = 0.0
    if x.device.type == "cpu":
        return fused_encoder_reference(x, key_valid, packed, n_heads, causal, act, eps, train,
                                       hidden_dropout, attn_dropout, seed)
    if x.device.type != "cuda":
        raise ValueError(f"no fused encoder kernel for device {x.device}")
    wants_grad = torch.is_grad_enabled() and (x.requires_grad
                                              or any(t.requires_grad for t in packed))
    if not wants_grad and hidden_dropout == 0.0 and attn_dropout == 0.0:
        return launch(x, key_valid, packed, n_heads, causal, act, eps)
    options = (n_heads, causal, act, eps, hidden_dropout, attn_dropout, seed)
    return _TrainingEncoder.apply(x, key_valid, options, *packed)
