"""K4b, the transformer-encoder backward, stage by stage.

The training forward (``fused_encoder.launch_train`` with ``save``) keeps
what the backward needs, per layer, over the ``R = N * L`` rows of the batch
(row ``n * L + l``): the layer's input ``x [R, D]``, ``qkv [R, 3D]``, the
attention context ``ctx [R, D]``, the first LayerNorm's centred input
``xc1 [R, D]``, its ``1 / std`` ``inv1 [R]`` and its output ``x1 [R, D]``,
the FFN's pre-activation ``h [R, inner]``, and the second LayerNorm's
``xc2 [R, D]`` and ``inv2 [R]`` (``SAVED_NAMES``; one float32 tensor
``[layers, fused_encoder.saved_floats]``, see ``saved_views``).

From the last layer to the first, the backward (``csrc/fused_encoder.cu``)
runs three launches over the whole batch:

* **R**, the rows: the second LayerNorm's backward and the FFN output's
  dropout give ``df``; ``dh = (df W2^T) * act'(h)``; ``dx1 = dpre2 + dh
  W1^T``; the first LayerNorm's backward and the attention output's dropout
  give ``dpre1`` (the residual's share of the layer's ``dx``) and ``dattn``;
  ``dctx = dattn Wo^T``; and each tile's LayerNorm column sums
  (``rows_backward_reference``, ``ln_tile_sums``);
* **A**, the attention, a sample at a time: the probabilities recomputed
  from the forward's scores, then ``dv``, ``dq``, ``dk`` and ``dx = dpre1
  + [dq dk dv] [Wq Wk Wv]^T`` (``attention_backward_reference``);
* **W**, the weight gradients: ``x^T [dq dk dv]``, ``ctx^T dattn``, ``x1^T
  dh``, ``act(h)^T df``, the bias column sums and R's LayerNorm sums, each
  over fixed chunks of rows (``wgrad_rows_per_chunk``, a function of ``R``
  alone), summed in chunk order after the last layer
  (``layer_grads_reference``).

Each stage has a plain PyTorch version beside it (``*_reference``); chained
over the layers (``layer_backward_reference``) they equal autograd through
``fused_encoder_reference``.  ``Stages`` launches the stages one at a time
on the card, to hold each launch to its plain version and to time it
alone.  The main path launches the whole backward in one call
(``fused_encoder.launch_backward``), and on the CPU runs the plain
version's autograd.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import numpy as np
import torch

from . import fused_encoder as fe

SAVED_NAMES = ("x", "qkv", "ctx", "xc1", "x1", "xc2", "h", "inv1", "inv2")
ROW_TILE = 64  # rows of R's blocks; its LayerNorm sums are per tile of these

_FNS = None


def _widths(D: int, inner: int) -> Dict[str, int]:
    return {"x": D, "qkv": 3 * D, "ctx": D, "xc1": D, "x1": D, "xc2": D, "h": inner,
            "inv1": 0, "inv2": 0}


def saved_views(saved: torch.Tensor, rows: int, D: int, inner: int) -> list:
    """Per layer, name -> view ([rows, width], or [rows] for inv1 and inv2)
    of the saved activations ``[layers, fused_encoder.saved_floats]``."""
    out = []
    for layer in saved:
        views, at = {}, 0
        for name, width in _widths(D, inner).items():
            size = rows * max(width, 1)
            flat = layer[at:at + size]
            views[name] = flat.view(rows, width) if width else flat
            at += size
        out.append(views)
    return out


def wgrad_rows_per_chunk(rows: int) -> int:
    """Rows of a chunk of the weight-gradient sums: ceil(rows / 64) rounded
    up to a multiple of ROW_TILE, at least 256 (a function of rows alone)."""
    per = -(-rows // 64)
    return max(256, -(-per // ROW_TILE) * ROW_TILE)


def wgrad_chunks(rows: int) -> list:
    """The [start, end) row ranges of the chunks, in the order summed."""
    per = wgrad_rows_per_chunk(rows)
    return [(s, min(rows, s + per)) for s in range(0, rows, per)]


def act_grad(h: torch.Tensor, act: str) -> torch.Tensor:
    """d act(h) / dh, as the kernels compute it."""
    if act == "relu":
        return (h > 0).to(h.dtype)
    if act == "gelu":
        c = 0.7978845608028654
        t = torch.tanh(c * (h + 0.044715 * h * h * h))
        return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * (c * (1.0 + 3.0 * 0.044715 * h * h))
    s = torch.sigmoid(h)
    return s * (1.0 + h * (1.0 - s))


def _ln_stats(pre: torch.Tensor, eps: float) -> tuple:
    xc = pre - pre.mean(-1, keepdim=True)
    inv = 1.0 / torch.sqrt((xc * xc).mean(-1) + eps)
    return xc, inv


def train_forward_reference(x: torch.Tensor, key_valid: torch.Tensor,
                            packed: Sequence[torch.Tensor], n_heads: int, causal: bool,
                            act: str, eps: float, hidden_dropout: float = 0.0,
                            attn_dropout: float = 0.0, seed: int = 0) -> tuple:
    """The training forward in plain PyTorch: (y, saved [layers,
    fused_encoder.saved_floats]) in the kernel's layout, with the kernels'
    masks."""
    wqkvo, bqkvo, w1, b1, w2, b2, ln_g, ln_b = packed
    N, L, D = x.shape
    layers, inner = wqkvo.shape[0], w1.shape[-1]
    R = N * L
    heads = (N, L, n_heads, D // n_heads)
    add_mask = fe.additive_mask(key_valid, causal)
    saved = x.new_empty(layers, fe.saved_floats(R, D, inner))
    views = saved_views(saved, R, D, inner)
    for li in range(layers):
        m_attn, m1, m2 = fe.layer_masks(seed, N, li, L, D, n_heads, hidden_dropout,
                                        attn_dropout, x.device)
        q, k, v = (torch.matmul(x, wqkvo[li, i]) + bqkvo[li, i] for i in range(3))
        probs = torch.softmax(fe.attention_scores(q.view(heads), k.view(heads), add_mask), -1)
        if m_attn is not None:
            probs = probs * m_attn
        ctx = torch.einsum("bhlm,bmhd->blhd", probs, v.view(heads)).reshape(N, L, D)
        a = torch.matmul(ctx, wqkvo[li, 3]) + bqkvo[li, 3]
        if m1 is not None:
            a = a * m1
        xc1, inv1 = _ln_stats(a + x, eps)
        x1 = xc1 * inv1[..., None] * ln_g[li, 0] + ln_b[li, 0]
        h = torch.matmul(x1, w1[li]) + b1[li]
        f = torch.matmul(fe._activate(h, act), w2[li]) + b2[li]
        if m2 is not None:
            f = f * m2
        xc2, inv2 = _ln_stats(f + x1, eps)
        values = {"x": x, "qkv": torch.cat([q, k, v], -1), "ctx": ctx, "xc1": xc1, "x1": x1,
                  "xc2": xc2, "h": h, "inv1": inv1, "inv2": inv2}
        for name, view in views[li].items():
            view.copy_(values[name].reshape(view.shape))
        x = xc2 * inv2[..., None] * ln_g[li, 1] + ln_b[li, 1]
    return x, saved


def _ln_backward(d: torch.Tensor, xc: torch.Tensor, inv: torch.Tensor,
                 gamma: torch.Tensor) -> tuple:
    """(dx, dgamma, dbeta) of LayerNorm rows from the centred input and 1/std."""
    xhat = xc * inv[:, None]
    dxhat = d * gamma
    dx = inv[:, None] * (dxhat - dxhat.mean(-1, keepdim=True)
                         - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, (d * xhat).sum(0), d.sum(0)


def _hidden_masks(seed, n, li, L, D, n_heads, hidden_dropout, device) -> tuple:
    _, m1, m2 = fe.layer_masks(seed, n, li, L, D, n_heads, hidden_dropout, 0.0, device)
    return tuple(None if m is None else m.reshape(n * L, D) for m in (m1, m2))


def ln_tile_sums(dx1: torch.Tensor, dy: torch.Tensor, sv: dict) -> torch.Tensor:
    """R's LayerNorm column sums per tile of ROW_TILE rows [tiles, 4 D]:
    sum dx1 * xhat1, dy * xhat2 (the gammas' gradients), then sum dx1, dy
    (the betas')."""
    R, D = dy.shape
    tiles = -(-R // ROW_TILE)

    def per_tile(t):
        return torch.cat([t, t.new_zeros(tiles * ROW_TILE - R, D)]).view(tiles, ROW_TILE, D).sum(1)

    xhat1, xhat2 = sv["xc1"] * sv["inv1"][:, None], sv["xc2"] * sv["inv2"][:, None]
    return torch.cat([per_tile(dx1 * xhat1), per_tile(dy * xhat2), per_tile(dx1),
                      per_tile(dy)], 1)


def rows_backward_reference(dy: torch.Tensor, sv: dict, packed: Sequence[torch.Tensor], li: int,
                            L: int, act: str, hidden_dropout: float = 0.0,
                            seed: int = 0) -> dict:
    """R of layer li in plain PyTorch: dy [R, D] and the layer's saved views
    -> dpre1, dx1, df, dh, dattn, dctx, the LayerNorm sums per tile
    (``ln_tile_sums``), and the layer's ln_g and ln_b gradients [2, D]."""
    wqkvo, _, w1, _, w2, _, ln_g, _ = packed
    R, D = dy.shape
    m1, m2 = _hidden_masks(seed, R // L, li, L, D, 1, hidden_dropout, dy.device)
    dpre2, g2, b2 = _ln_backward(dy, sv["xc2"], sv["inv2"], ln_g[li, 1])
    df = dpre2 if m2 is None else dpre2 * m2
    dh = torch.matmul(df, w2[li].t()) * act_grad(sv["h"], act)
    dx1 = dpre2 + torch.matmul(dh, w1[li].t())
    dpre1, g1, b1 = _ln_backward(dx1, sv["xc1"], sv["inv1"], ln_g[li, 0])
    dattn = dpre1 if m1 is None else dpre1 * m1
    return {"dpre1": dpre1, "dx1": dx1, "df": df, "dh": dh, "dattn": dattn,
            "dctx": torch.matmul(dattn, wqkvo[li, 3].t()), "ln_part": ln_tile_sums(dx1, dy, sv),
            "ln_g": torch.stack([g1, g2]), "ln_b": torch.stack([b1, b2])}


def attention_backward_reference(sv: dict, key_valid: torch.Tensor, dctx: torch.Tensor,
                                 dpre1: torch.Tensor, packed: Sequence[torch.Tensor], li: int,
                                 n_heads: int, causal: bool, attn_dropout: float = 0.0,
                                 seed: int = 0) -> tuple:
    """A of layer li in plain PyTorch: (dx [R, D], dqkv [R, 3D]) from the
    saved q, k, v, dctx and dpre1 [R, D]."""
    wqkvo = packed[0]
    N, L = key_valid.shape
    D = dctx.shape[1]
    heads = (N, L, n_heads, D // n_heads)
    q, k, v = (t.reshape(heads) for t in sv["qkv"].split(D, dim=1))
    probs = torch.softmax(fe.attention_scores(q, k, fe.additive_mask(key_valid, causal)), -1)
    mask = (fe.dropout_scale(seed, N, li, fe.ATTN_SITE, (n_heads, L, L), attn_dropout,
                             dctx.device) if attn_dropout > 0 else None)
    dc = dctx.reshape(heads)
    dp = torch.einsum("blhd,bmhd->bhlm", dc, v)
    pb = probs
    if mask is not None:
        dp, pb = dp * mask, probs * mask
    sqrt_dh = float(np.sqrt(np.float32(D // n_heads)))
    ds = probs * (dp - (dp * probs).sum(-1, keepdim=True)) / sqrt_dh
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k).reshape(N * L, D)
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q).reshape(N * L, D)
    dv = torch.einsum("bhlm,blhd->bmhd", pb, dc).reshape(N * L, D)
    dx = dpre1 + sum(torch.matmul(d, wqkvo[li, i].t()) for i, d in enumerate((dq, dk, dv)))
    return dx, torch.cat([dq, dk, dv], 1)


def weight_grads_reference(sv: dict, dqkv: torch.Tensor, dattn: torch.Tensor,
                           dh: torch.Tensor, df: torch.Tensor, act: str) -> dict:
    """W of one layer in plain PyTorch (its LayerNorm sums come from R):
    name -> the layer's gradient of wqkvo [4, D, D], bqkvo [4, D], w1, b1,
    w2, b2."""
    D = dattn.shape[1]
    dq, dk, dv = dqkv.split(D, dim=1)
    x, ctx = sv["x"], sv["ctx"]
    return {"wqkvo": torch.stack([x.t() @ dq, x.t() @ dk, x.t() @ dv, ctx.t() @ dattn]),
            "bqkvo": torch.stack([dq.sum(0), dk.sum(0), dv.sum(0), dattn.sum(0)]),
            "w1": sv["x1"].t() @ dh, "b1": dh.sum(0),
            "w2": fe._activate(sv["h"], act).t() @ df, "b2": df.sum(0)}


def layer_grads_reference(sv: dict, ln_part: torch.Tensor, dqkv: torch.Tensor,
                          dattn: torch.Tensor, dh: torch.Tensor, df: torch.Tensor,
                          act: str) -> dict:
    """W as the card runs it: ``weight_grads_reference``, and the layer's
    LayerNorm gradients [2, D] from R's tile sums ``ln_part``."""
    out = weight_grads_reference(sv, dqkv, dattn, dh, df, act)
    D = dattn.shape[1]
    total = ln_part.sum(0)
    out["ln_g"], out["ln_b"] = total[:2 * D].view(2, D), total[2 * D:].view(2, D)
    return out


def layer_backward_reference(saved: torch.Tensor, key_valid: torch.Tensor, dy: torch.Tensor,
                             packed: Sequence[torch.Tensor], n_heads: int, causal: bool,
                             act: str, hidden_dropout: float = 0.0, attn_dropout: float = 0.0,
                             seed: int = 0) -> tuple:
    """The three stages chained from the last layer to the first: (dx [N, L,
    D], the 8 packed arrays' gradients)."""
    N, L, D = dy.shape
    layers, inner = packed[0].shape[0], packed[2].shape[-1]
    views = saved_views(saved, N * L, D, inner)
    grads = [torch.zeros_like(t) for t in packed]
    d = dy.reshape(N * L, D)
    for li in range(layers - 1, -1, -1):
        r = rows_backward_reference(d, views[li], packed, li, L, act, hidden_dropout, seed)
        d, dqkv = attention_backward_reference(views[li], key_valid, r["dctx"], r["dpre1"],
                                               packed, li, n_heads, causal, attn_dropout, seed)
        w = weight_grads_reference(views[li], dqkv, r["dattn"], r["dh"], r["df"], act)
        for i, name in enumerate(fe.PACKED_NAMES[:6]):
            grads[i][li] = w[name]
        grads[6][li], grads[7][li] = r["ln_g"], r["ln_b"]
    return d.reshape(N, L, D), tuple(grads)


# ----------------------------------------------------------- the card's stages
def bind(lib: ctypes.CDLL) -> dict:
    """name -> the stage entry points of a built ``fused_encoder`` library."""
    p, i, u, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                      ctypes.c_longlong)
    drop = [u, u, u, f, f, i, i, u]
    sig = {"rp_encoder_bwd_transpose_f32": [p] * 4 + [i] * 3 + [p],
           "rp_encoder_bwd_rows_f32": [p] * 11 + [ll] + [i] * 6 + drop + [p],
           "rp_encoder_bwd_attention_f32": [p] * 6 + [ll] + [i] * 7 + drop + [p],
           "rp_encoder_bwd_wgrad_f32": [p] * 7 + [ll] + [i] * 6 + [p],
           "rp_encoder_bwd_sum_f32": [p] * 2 + [ll] + [i] * 4 + [p],
           "rp_fused_encoder_wgrad_rows_per_chunk": [ll]}
    fns = {}
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
        fns[name] = fn
    return fns


def _functions():
    global _FNS
    if _FNS is None:
        from . import _build

        _FNS = bind(_build.load("fused_encoder"))
    return _FNS


def kernel_rows_per_chunk(rows: int) -> int:
    """The kernel's chunk rows for ``rows`` rows (held to wgrad_rows_per_chunk)."""
    return _functions()["rp_fused_encoder_wgrad_rows_per_chunk"](rows)


def transposed_weights_reference(packed: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per layer, wo^T [D, D], w2^T [D, inner], w1^T [inner, D] and [wq wk
    wv]^T [3D, D], flattened, as the backward's launches read them."""
    wqkvo, w1, w2 = packed[0], packed[2], packed[4]
    return torch.cat([torch.cat([wqkvo[li, 3].t().reshape(-1), w2[li].t().reshape(-1),
                                 w1[li].t().reshape(-1),
                                 wqkvo[li, :3].transpose(1, 2).reshape(-1)])
                      for li in range(wqkvo.shape[0])])


class Stages:
    """K4b's launches for layer li one at a time, on CUDA buffers allocated
    here once (for holding each launch to its plain version, and for timing
    it alone): ``calls[stage]()`` launches one kernel.  Each stage reads
    the buffers the previous one wrote: ``transpose`` -> ``wt``; ``rows``
    reads dy and writes dpre1, dx1, df, dh, dattn, dctx and ln_part;
    ``attention`` turns dpre1 into the layer's dx (in place) and writes
    dqkv; ``wgrad`` writes layer li's entries of each chunk's slice of
    ``partials``; ``sum`` adds the slices into ``grads`` (``layer_grads``
    reads layer li's)."""

    NAMES = ("transpose", "rows", "attention", "wgrad", "sum")

    def __init__(self, saved: torch.Tensor, key_valid: torch.Tensor, dy: torch.Tensor,
                 packed: Sequence[torch.Tensor], n_heads: int, causal: bool, act: str,
                 hidden_dropout: float, attn_dropout: float, seed: int, li: int):
        N, L, D = dy.shape
        R = N * L
        layers, inner = packed[0].shape[0], packed[2].shape[-1]
        if saved.shape != (layers, fe.saved_floats(R, D, inner)) or not saved.is_contiguous():
            raise ValueError(f"saved must be contiguous [{layers}, "
                             f"{fe.saved_floats(R, D, inner)}], got {tuple(saved.shape)}")
        self.packed, self.li = packed, li
        self.kv = key_valid.to(torch.float32).contiguous()
        self.dy = dy.reshape(R, D).contiguous()
        self.buf = {k: dy.new_empty(R, {"dh": inner, "dqkv": 3 * D}.get(k, D))
                    for k in ("dpre1", "dx1", "df", "dh", "dattn", "dctx", "dqkv")}
        self.buf["ln_part"] = dy.new_empty(-(-R // ROW_TILE), 4 * D)
        self.wt = dy.new_empty(layers * (4 * D * D + 2 * D * inner))
        self.partials = dy.new_zeros(len(wgrad_chunks(R)), sum(t.numel() for t in packed))
        self.grads = dy.new_empty(self.partials.shape[1])
        b = {k: v.data_ptr() for k, v in self.buf.items()}
        wqkvo, w1, w2, ln_g = packed[0], packed[2], packed[4], packed[6]
        act_id = fe.ACTIVATIONS[act]
        args = {
            "transpose": ("rp_encoder_bwd_transpose_f32", wqkvo.data_ptr(), w1.data_ptr(),
                          w2.data_ptr(), self.wt.data_ptr(), D, inner, layers),
            "rows": ("rp_encoder_bwd_rows_f32", saved.data_ptr(), self.wt.data_ptr(),
                     ln_g.data_ptr(), self.dy.data_ptr(),
                     *(b[k] for k in ("dpre1", "dx1", "df", "dh", "dattn", "dctx", "ln_part")),
                     N, L, D, layers, inner, act_id, li,
                     *fe._dropout_args(seed, hidden_dropout, 0.0)),
            "attention": ("rp_encoder_bwd_attention_f32", saved.data_ptr(), self.wt.data_ptr(),
                          self.kv.data_ptr(), b["dctx"], b["dpre1"], b["dqkv"], N, L, D, layers,
                          n_heads, inner, int(bool(causal)), li,
                          *fe._dropout_args(seed, 0.0, attn_dropout)),
            "wgrad": ("rp_encoder_bwd_wgrad_f32", saved.data_ptr(),
                      *(b[k] for k in ("ln_part", "df", "dh", "dattn", "dqkv")),
                      self.partials.data_ptr(), R, 1, D, layers, inner, act_id, li),
            "sum": ("rp_encoder_bwd_sum_f32", self.partials.data_ptr(), self.grads.data_ptr(),
                    R, 1, D, layers, inner),
        }
        self.calls = {stage: self._launcher(*args[stage]) for stage in self.NAMES}

    @staticmethod
    def _launcher(name: str, *args):
        def call():
            err = _functions()[name](*args, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name} failed: CUDA error {err}")
        return call

    def run(self, *stages: str) -> None:
        with torch.cuda.device(self.dy.device):
            for stage in stages:
                self.calls[stage]()

    def layer_grads(self) -> dict:
        """name -> layer li's gradient of each packed array, after ``sum``."""
        parts = self.grads.split([t.numel() for t in self.packed])
        return {n: g.view(t.shape)[self.li]
                for n, g, t in zip(fe.PACKED_NAMES, parts, self.packed)}
