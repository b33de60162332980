"""IOCRec's global-attention encoder: a learned query bank over each history.

Replaces the JAX package's K6f and K6b (``rec_pangu_tpu/ops/kernels/
global_attn.py``: ``_fwd_kernel``, ``_bwd_kernel``, behind the ``global_attn``
custom VJP).  For x ``[N, L, D]`` and params ``(wk [D, D], bk [D], wv [D, D],
bv [D], q_s [L, D])`` (flax ``[in, out]`` kernels)::

    y = drop(softmax(q_s (x wk + bk)^T) (x wv + bv))

with no ``1/sqrt(D)`` scale and, as in the reference, no padding mask: a
padded position is attended like a real one.

The CUDA kernels (``rec_pangu_tpu_torch/csrc/global_attn.cu``) share one
design and one recompute of k, v and the probabilities, so the backward sees
the forward's probabilities bit for bit.  Persistent blocks keep q_s and,
where they fit (every D <= 64), wk and wv in shared memory for a block's
whole run of samples; groups of 256 threads, each with a barrier of its own,
take one sample at a time and run its products in 4 x 4 register tiles of
float4 operands.  The forward runs up to four groups a block (218,688 B of
shared memory at IOCRec's L=50, D=64), at most one block an SM: group j of
the G in all (``forward_groups``) takes samples ``[j N / G, (j + 1) N / G)``,
and its y does not depend on the group.  The backward runs two groups a
block and adds the parameter gradients to sums held in registers, written
once per group into 264 slices that a second launch adds in order (no
atomics: the same bits every run).  Shapes whose buffers do not fit stream
wk and wv from zero-padded copies in a workspace instead.  Bound:
operations, 1,459,200 FLOP a sample forward and 4,057,600 backward at L=50,
D=64; what holds each kernel back is in PERF.md.  The wrapper launches them
for CUDA tensors and raises if it cannot (a shape outside
``MAX_L``/``MAX_D`` is a ``ValueError``); the plain version below serves
tensors on the CPU.

Dropout (training) multiplies the output by the fused encoder's hash masks
(``fused_encoder.dropout_scale``) at layer ``DROPOUT_LAYER``, site
``OUTPUT_SITE``: a stream the encoder's ``3 * layer + site`` never reaches,
so the card and the CPU draw the same masks for a seed and the encoder's
sites draw others.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .fused_encoder import _MASK32, check_rate, drop_scale, drop_threshold, dropout_scale

LAUNCHES = 0
BACKWARD_LAUNCHES = 0

MAX_L = 64    # a quarter-warp holds one row of scores, eight keys a lane
MAX_D = 128   # the streamed variants' buffers stay within a block's shared memory
PARAM_NAMES = ("wk", "bk", "wv", "bv", "q_s")
# dropout streams of IOCRec's own sites, above every transformer layer's
DROPOUT_LAYER = 256
OUTPUT_SITE = 0   # this encoder's output
INPUT_SITE = 1    # IOCRec's input dropout (models/sequence/iocrec.py)

_FWD_FN = None
_BWD_FN = None


def output_mask(seed: int, n: int, L: int, D: int, rate: float, device=None) -> torch.Tensor:
    """The output's dropout factors [n, L, D] (0 dropped, 1/(1-p) kept)."""
    return dropout_scale(seed, n, DROPOUT_LAYER, OUTPUT_SITE, (L, D), rate, device)


def global_attn_reference(x: torch.Tensor, params: Sequence[torch.Tensor], train: bool = False,
                          rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version (the flax path of ``GlobalSeqEncoder``)."""
    wk, bk, wv, bv, q_s = params
    k = torch.matmul(x, wk) + bk
    v = torch.matmul(x, wv) + bv
    probs = torch.softmax(torch.einsum("ld,bmd->blm", q_s, k), dim=-1)
    y = torch.einsum("blm,bmd->bld", probs, v)
    if train and rate > 0:
        N, L, D = x.shape
        y = y * output_mask(seed, N, L, D, rate, x.device)
    return y


def check_inputs(x: torch.Tensor, params: Sequence[torch.Tensor]) -> None:
    """Raise ValueError on inputs of the wrong structure."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 [N, L, D], got {tuple(x.shape)} {x.dtype}")
    N, L, D = x.shape
    if len(params) != len(PARAM_NAMES):
        raise ValueError(f"params must be the {len(PARAM_NAMES)} arrays {PARAM_NAMES}, "
                         f"got {len(params)}")
    for name, t, shape in zip(PARAM_NAMES, params, ((D, D), (D,), (D, D), (D,), (L, D))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {list(shape)}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")


def check_supported(L: int, D: int) -> None:
    """Raise ValueError on a shape the kernels do not take."""
    if not (1 <= L <= MAX_L and 1 <= D <= MAX_D):
        raise ValueError(f"the global attention kernels take 1 <= L <= {MAX_L} and "
                         f"1 <= D <= {MAX_D}; got L={L}, D={D}")


def _bind_forward(lib):
    """(forward, its workspace words, its groups) of a loaded library."""
    fwd = lib.rp_global_attn_fwd_f32
    fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                    + [ctypes.c_uint] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    words = lib.rp_global_attn_fwd_workspace_words
    words.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    groups = lib.rp_global_attn_fwd_groups
    groups.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    words.restype = groups.restype = ctypes.c_longlong
    return fwd, words, groups


def _functions():
    """((forward, its workspace words, its groups), (backward, its workspace
    words)) from the library."""
    global _FWD_FN, _BWD_FN
    if _FWD_FN is None:
        from . import _build

        lib = _build.load("global_attn")
        bwd = lib.rp_global_attn_bwd_f32
        bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 2
                        + [ctypes.c_int, ctypes.c_int] + [ctypes.c_uint] * 3
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        words = lib.rp_global_attn_bwd_workspace_words
        words.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        words.restype = ctypes.c_longlong
        _FWD_FN = _bind_forward(lib)
        _BWD_FN = bwd, words
    return _FWD_FN, _BWD_FN


def _variant(resident: Optional[bool]) -> int:
    return -1 if resident is None else int(resident)


def _dropout_args(seed: int, rate: float) -> tuple:
    return (int(seed) & _MASK32, 3 * DROPOUT_LAYER + OUTPUT_SITE, drop_threshold(rate),
            drop_scale(rate), int(rate > 0))


def _checked(x: torch.Tensor, params: Sequence[torch.Tensor]):
    N, L, D = x.shape
    check_supported(L, D)
    if not (x.is_contiguous() and all(t.is_contiguous() for t in params)):
        raise ValueError("the global attention kernels take contiguous x and params")
    return N, L, D


def forward_groups(n: int, L: int, D: int) -> int:
    """The forward's groups on the current CUDA device for n samples of L x D
    (group j takes samples ``[j n / G, (j + 1) n / G)``); 0 for a shape it
    does not take."""
    (_, _, groups), _ = _functions()
    return int(groups(n, L, D))


def launch_forward(x: torch.Tensor, params: Sequence[torch.Tensor], rate: float, seed: int,
                   resident: Optional[bool] = None) -> torch.Tensor:
    """K6f on checked CUDA inputs: y [N, L, D] (dropout at ``rate``).
    ``resident`` picks the kernel's variant as in ``launch_backward``."""
    global LAUNCHES
    N, L, D = _checked(x, params)
    y = torch.empty_like(x)
    if N == 0:
        return y
    (fwd, words, _), _ = _functions()
    variant = _variant(resident)
    with torch.cuda.device(x.device):
        need = words(N, L, D, variant)
        if need < 0:
            raise ValueError(f"the global attention forward cannot run with resident="
                             f"{resident} at L={L}, D={D}")
        work = torch.empty(need, dtype=torch.float32, device=x.device) if need else None
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fwd(x.data_ptr(), *(t.data_ptr() for t in params), y.data_ptr(),
                  0 if work is None else work.data_ptr(), need, N, L, D,
                  *_dropout_args(seed, rate), variant, stream)
    if err != 0:
        raise RuntimeError(f"global_attn kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y


def launch_backward(x: torch.Tensor, params: Sequence[torch.Tensor], dy: torch.Tensor,
                    rate: float, seed: int, resident: Optional[bool] = None):
    """K6b on CUDA inputs: (dx [N, L, D], the 5 params' gradients).
    ``resident`` picks the kernel's variant: wk and wv kept in shared memory
    (True, where they fit) or streamed from device memory (False); None lets
    the kernel pick from the shape, as training does."""
    global BACKWARD_LAUNCHES
    N, L, D = _checked(x, params)
    dy = dy.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    grads = torch.empty(sum(t.numel() for t in params), dtype=torch.float32, device=x.device)
    if N == 0:
        grads.zero_()
    else:
        _, (bwd, words) = _functions()
        variant = _variant(resident)
        need = words(N, L, D, variant)
        if need == 0:
            raise ValueError(f"the global attention backward cannot keep the weights in "
                             f"shared memory at L={L}, D={D}")
        work = torch.empty(need, dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = bwd(x.data_ptr(), *(t.data_ptr() for t in params), dy.data_ptr(),
                      dx.data_ptr(), grads.data_ptr(), work.data_ptr(), work.numel(), N, L, D,
                      *_dropout_args(seed, rate), variant, stream)
        if err != 0:
            raise RuntimeError(f"global_attn backward kernel launch failed: CUDA error {err}")
        BACKWARD_LAUNCHES += 1
    return dx, tuple(g.view(t.shape) for g, t in
                     zip(grads.split([t.numel() for t in params]), params))


class _GlobalAttn(torch.autograd.Function):
    """K6f; its backward is K6b, which recomputes the forward from x."""

    @staticmethod
    def forward(ctx, x, rate, seed, *params):
        ctx.options = (rate, seed)
        ctx.save_for_backward(x, *params)
        return launch_forward(x, params, rate, seed)

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        dx, grads = launch_backward(x, params, dy, *ctx.options)
        return (dx, None, None, *grads)


def global_attn(x: torch.Tensor, params: Sequence[torch.Tensor], seed: int = 0,
                rate: float = 0.0, train: bool = False) -> torch.Tensor:
    """x [N, L, D] f32 and (wk, bk, wv, bv, q_s) -> y [N, L, D]: the kernels
    on the card, the plain version on the CPU.  ``train`` applies dropout at
    ``rate`` with the masks of ``seed``."""
    check_inputs(x, params)
    check_rate(rate)
    if not train:
        rate = 0.0
    if x.device.type == "cpu":
        return global_attn_reference(x, params, train, rate, seed)
    if x.device.type != "cuda":
        raise ValueError(f"no global attention kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in params)):
        return _GlobalAttn.apply(x, rate, seed, *params)
    return launch_forward(x, params, rate, seed)
