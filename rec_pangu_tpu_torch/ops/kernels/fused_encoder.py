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

The wrapper launches the kernel for CUDA tensors and raises if it cannot
(a shape outside ``MAX_L``/``MAX_D``/``inner <= 4 D`` is a ``ValueError``);
it uses the plain version below only for tensors on the CPU.  There is no
backward yet: a call that autograd would have to differentiate raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

# kernel launches so far; a run resets it and reads it to show the path
# went through the kernel
LAUNCHES = 0

ACTIVATIONS = {"relu": 0, "gelu": 1, "swish": 2, "silu": 2}
MAX_L = 64    # a warp holds one row of scores, two keys a lane
MAX_D = 128   # five [L, D + 1] float buffers stay within a block's shared memory
PACKED_NAMES = ("wqkvo", "bqkvo", "w1", "b1", "w2", "b2", "ln_g", "ln_b")
_NEG = -1e6

_FN = None


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


def fused_encoder_reference(x: torch.Tensor, key_valid: torch.Tensor,
                            packed: Sequence[torch.Tensor], n_heads: int,
                            causal: bool = True, act: str = "relu",
                            eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version over the packed weights: [N, L, D] -> [N, L, D]."""
    wqkvo, bqkvo, w1, b1, w2, b2, ln_g, ln_b = packed
    N, L, D = x.shape
    heads = (N, L, n_heads, D // n_heads)
    add_mask = additive_mask(key_valid, causal)
    for li in range(wqkvo.shape[0]):
        q, k, v = (torch.matmul(x, wqkvo[li, i]) + bqkvo[li, i] for i in range(3))
        probs = torch.softmax(attention_scores(q.view(heads), k.view(heads), add_mask), dim=-1)
        ctx = torch.einsum("bhlm,bmhd->blhd", probs, v.view(heads)).reshape(N, L, D)
        a = torch.matmul(ctx, wqkvo[li, 3]) + bqkvo[li, 3]
        x1 = F.layer_norm(a + x, (D,), ln_g[li, 0], ln_b[li, 0], eps)
        h = _activate(torch.matmul(x1, w1[li]) + b1[li], act)
        f = torch.matmul(h, w2[li]) + b2[li]
        x = F.layer_norm(f + x1, (D,), ln_g[li, 1], ln_b[li, 1], eps)
    return x


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


def fused_encoder(x: torch.Tensor, key_valid: torch.Tensor, packed: Sequence[torch.Tensor],
                  n_heads: int, causal: bool = True, act: str = "relu",
                  eps: float = 1e-12) -> torch.Tensor:
    """x [N, L, D] f32, key_valid [N, L] (nonzero = valid key), the 8 packed
    weight arrays -> y [N, L, D]: the kernel on the card, the plain version
    on the CPU."""
    check_inputs(x, key_valid, packed, n_heads, act)
    if x.device.type == "cpu":
        return fused_encoder_reference(x, key_valid, packed, n_heads, causal, act, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no fused encoder kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in packed)):
        raise NotImplementedError(
            "the fused encoder kernel has no backward yet (K4b arrives with SASRec "
            "training, ROADMAP Queue 1 item 3b); run the forward under torch.no_grad() "
            "or torch.inference_mode()")
    return launch(x, key_valid, packed, n_heads, causal, act, eps)
