"""K4b's stages (``ops/kernels/encoder_bwd.py``) against autograd and JAX.

The card's backward runs three launches a layer (R: LayerNorms and FFN
rows; A: attention a sample at a time; W: weight gradients over fixed row
chunks).  Their plain PyTorch versions are held here, at the small shape of
``test_torch_encoder_grad.py``:

* chained over the layers, from the plain training forward's saved
  activations, they equal autograd through ``fused_encoder_reference``
  (every row, empty histories and dropout included) and ``jax.grad``
  through the JAX ``fused_encoder`` in interpret mode, i.e. the Pallas
  ``_bwd_kernel`` (K4b), on rows with a valid key;
* each stage alone equals the matching slice of autograd: R against the
  LayerNorm and FFN part, A against the attention, W against ``x^T g``
  sums in float64;
* W's chunks of rows depend on ``N * L`` alone and cover every row once.

Tolerance: ``test_torch_encoder_grad``'s, each array within rtol 1e-5 and an
atol of 1e-5 times its largest entry (at least 1e-5).  The CUDA launches run
only on the card (``chip_smoke.py``), where each is held to these versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rec_pangu_tpu.ops.kernels.fused_encoder import fused_encoder as jax_fused_encoder
from rec_pangu_tpu.ops.kernels.fused_encoder import pack_params
from rec_pangu_tpu.ops.sequence_enc import TransformerEncoder as JaxEncoder
from rec_pangu_tpu_torch.ops.kernels import encoder_bwd as eb
from rec_pangu_tpu_torch.ops.kernels import fused_encoder as fe
from rec_pangu_tpu_torch.ops.sequence_enc import TransformerEncoder

N, L, D, HEADS, INNER, LAYERS, EPS = 8, 12, 8, 2, 16, 2, 1e-3
RATE, SEED = 0.2, 11
ACTS = ("relu", "gelu", "swish")


def _assert_close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=name)


def _inputs(seed, n=N, empty=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, L, D)).astype(np.float32)
    lens = rng.integers(1, L + 1, n)
    lens[list(empty)] = 0
    key_valid = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    dy = rng.standard_normal((n, L, D)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(key_valid), torch.from_numpy(dy)


def _packed(act, seed=5):
    enc = TransformerEncoder(D, LAYERS, HEADS, INNER, 0.0, 0.0, act, EPS,
                             torch.Generator().manual_seed(seed))
    with torch.no_grad():  # small random biases and LayerNorm terms, so every term counts
        gen = torch.Generator().manual_seed(seed + 1)
        for p in enc.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return [t.detach().clone() for t in enc.packed()]


def _autograd(x, kv, dy, packed, act, causal, rate):
    xs = x.clone().requires_grad_()
    ps = [t.clone().requires_grad_() for t in packed]
    y = fe.fused_encoder_reference(xs, kv, ps, HEADS, causal, act, EPS, True, rate, rate, SEED)
    grads = torch.autograd.grad(y, [xs] + ps, dy)
    return y.detach(), grads[0], grads[1:]


def _chained(x, kv, dy, packed, act, causal, rate):
    y, saved = eb.train_forward_reference(x, kv, packed, HEADS, causal, act, EPS, rate, rate,
                                          SEED)
    dx, grads = eb.layer_backward_reference(saved, kv, dy, packed, HEADS, causal, act, rate,
                                            rate, SEED)
    return y, dx, grads


def _assert_grads(got, want):
    for name, a, b in zip(("y", "dx") + fe.PACKED_NAMES, [got[0], got[1], *got[2]],
                          [want[0], want[1], *want[2]]):
        _assert_close(a, b, name)


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("act,causal", [(a, c) for a in ACTS for c in (True, False)])
def test_chained_stages_match_autograd(act, causal, rate):
    x, kv, dy = _inputs(1, empty=(2, 5))
    packed = _packed(act)
    _assert_grads(_chained(x, kv, dy, packed, act, causal, rate),
                  _autograd(x, kv, dy, packed, act, causal, rate))


def test_chained_stages_match_autograd_one_sample():
    x, kv, dy = _inputs(2, n=1)
    packed = _packed("gelu")
    _assert_grads(_chained(x, kv, dy, packed, "gelu", True, RATE),
                  _autograd(x, kv, dy, packed, "gelu", True, RATE))


def _flax_mask(key_valid, causal):
    ok = key_valid[:, None, None, :].astype(bool)
    if causal:
        ok = ok & np.tril(np.ones((L, L), bool))
    return jnp.where(ok, 0.0, -1e6)


@pytest.mark.parametrize("act,causal", [(a, c) for a in ACTS for c in (True, False)])
def test_chained_stages_match_jax_kernel_interpret(act, causal, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
    x, kv, dy = _inputs(3)  # no empty history: every row has a valid key
    enc = JaxEncoder(n_layers=LAYERS, n_heads=HEADS, inner_size=INNER, hidden_dropout_prob=0.0,
                     attn_dropout_prob=0.0, hidden_act=act, layer_norm_eps=EPS)
    params = enc.init({"params": jax.random.PRNGKey(4)}, x.numpy(),
                      _flax_mask(kv.numpy(), causal), False)["params"]
    jpacked = pack_params(params, LAYERS)

    def loss(p, xx):
        y = jax_fused_encoder(xx, p, jnp.asarray(kv.numpy()), jnp.int32(0), LAYERS, HEADS,
                              INNER, 0.0, 0.0, EPS, True, 4, True, causal, act)
        return jnp.vdot(y, jnp.asarray(dy.numpy()))

    g_packed, g_x = jax.grad(loss, argnums=(0, 1))(jpacked, jnp.asarray(x.numpy()))
    packed = [torch.from_numpy(np.array(a)) for a in jpacked]
    _, dx, grads = _chained(x, kv, dy, packed, act, causal, 0.0)
    for name, a, b in zip(("dx",) + fe.PACKED_NAMES, [dx, *grads], [g_x, *g_packed]):
        _assert_close(a, b, name)


def _layer(act, causal, rate, li=LAYERS - 1, empty=(2, 5)):
    """The plain forward's saved views of layer li, its inputs and packed weights."""
    x, kv, dy = _inputs(6, empty=empty)
    packed = _packed(act)
    _, saved = eb.train_forward_reference(x, kv, packed, HEADS, causal, act, EPS, rate, rate,
                                          SEED)
    return saved, eb.saved_views(saved, N * L, D, INNER)[li], kv, dy.reshape(N * L, D), packed


@pytest.mark.parametrize("act", ACTS)
def test_rows_stage_matches_layernorm_and_ffn_autograd(act):
    li = LAYERS - 1
    _, sv, kv, dy, packed = _layer(act, True, RATE)
    wqkvo, bqkvo, w1, b1, w2, b2, ln_g, ln_b = packed
    _, m1, m2 = fe.layer_masks(SEED, N, li, L, D, HEADS, RATE, 0.0)
    m1, m2 = m1.reshape(N * L, D), m2.reshape(N * L, D)
    ctx = sv["ctx"].clone().requires_grad_()
    x = sv["x"].clone().requires_grad_()
    g = ln_g[li].clone().requires_grad_()
    b = ln_b[li].clone().requires_grad_()
    a = ctx @ wqkvo[li, 3] + bqkvo[li, 3]
    a.retain_grad()
    x1 = F.layer_norm(a * m1 + x, (D,), g[0], b[0], EPS)
    x1.retain_grad()
    h = x1 @ w1[li] + b1[li]
    h.retain_grad()
    f = fe._activate(h, act) @ w2[li] + b2[li]
    f.retain_grad()
    y = F.layer_norm(f * m2 + x1, (D,), g[1], b[1], EPS)
    y.backward(dy)
    r = eb.rows_backward_reference(dy, sv, packed, li, L, act, RATE, SEED)
    for name, want in (("dpre1", x.grad), ("dattn", a.grad), ("dctx", ctx.grad),
                       ("dh", h.grad), ("df", f.grad), ("ln_g", g.grad), ("ln_b", b.grad)):
        _assert_close(r[name], want, name)
    # dx1 is the gradient reaching x1 through both its uses
    _assert_close(r["dx1"], x1.grad, "dx1")
    # the tiles' LayerNorm sums add up to the LayerNorms' gradients
    _assert_close(r["ln_part"].sum(0), torch.cat([g.grad.reshape(-1), b.grad.reshape(-1)]),
                  "ln_part")


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_stage_matches_attention_autograd(causal, rate):
    li = LAYERS - 1
    _, sv, kv, _, packed = _layer("gelu", causal, rate)
    wqkvo, bqkvo = packed[:2]
    gen = torch.Generator().manual_seed(8)
    dctx = torch.randn(N * L, D, generator=gen)
    dpre1 = torch.randn(N * L, D, generator=gen)
    heads = (N, L, HEADS, D // HEADS)
    mask = fe.dropout_scale(SEED, N, li, fe.ATTN_SITE, (HEADS, L, L), rate) if rate else None

    def attention(q, k, v):
        p = torch.softmax(fe.attention_scores(q.view(heads), k.view(heads),
                                              fe.additive_mask(kv, causal)), -1)
        if mask is not None:
            p = p * mask
        return torch.einsum("bhlm,bmhd->blhd", p, v.view(heads)).reshape(N * L, D)

    qkv = [t.clone().requires_grad_() for t in sv["qkv"].split(D, dim=1)]
    attention(*qkv).backward(dctx)
    dx, dqkv = eb.attention_backward_reference(sv, kv, dctx, dpre1, packed, li, HEADS, causal,
                                               rate, SEED)
    _assert_close(dqkv, torch.cat([t.grad for t in qkv], 1), "dqkv")
    # dx: the projections' share, through autograd from the layer's input
    x = sv["x"].clone().requires_grad_()
    attention(*(x @ wqkvo[li, i] + bqkvo[li, i] for i in range(3))).backward(dctx)
    _assert_close(dx, dpre1 + x.grad, "dx")


@pytest.mark.parametrize("act", ACTS)
def test_weight_grads_stage_matches_row_sums(act):
    saved, sv, _, dy, packed = _layer(act, True, RATE, li=0)
    gen = torch.Generator().manual_seed(9)
    dqkv, dattn, dh, df, dx1 = (torch.randn(N * L, w, generator=gen)
                                for w in (3 * D, D, INNER, D, D))
    got = eb.layer_grads_reference(sv, eb.ln_tile_sums(dx1, dy, sv), dqkv, dattn, dh, df, act)
    d64 = {k: v.double() for k, v in sv.items()}
    q, k, v = dqkv.double().split(D, dim=1)
    want = {"wqkvo": torch.stack([d64["x"].t() @ q, d64["x"].t() @ k, d64["x"].t() @ v,
                                  d64["ctx"].t() @ dattn.double()]),
            "bqkvo": torch.stack([q.sum(0), k.sum(0), v.sum(0), dattn.double().sum(0)]),
            "w1": d64["x1"].t() @ dh.double(), "b1": dh.double().sum(0),
            "w2": fe._activate(d64["h"], act).t() @ df.double(), "b2": df.double().sum(0),
            "ln_g": torch.stack([(dx1.double() * d64["xc1"] * d64["inv1"][:, None]).sum(0),
                                 (dy.double() * d64["xc2"] * d64["inv2"][:, None]).sum(0)]),
            "ln_b": torch.stack([dx1.double().sum(0), dy.double().sum(0)])}
    assert set(got) == set(fe.PACKED_NAMES)
    for name in fe.PACKED_NAMES:
        _assert_close(got[name], want[name], name)


def test_backward_refuses_a_saved_buffer_of_another_layout():
    """The saved activations are one [layers, saved_floats] buffer; the
    older per-layer-input layout, or a wrong size, is refused before any
    launch."""
    saved, _, kv, dy, packed = _layer("gelu", True, RATE)
    opts = (HEADS, True, "gelu", EPS, RATE, RATE, SEED)
    for bad in (saved.new_zeros(LAYERS, N, L, D), saved[:, :-1].contiguous()):
        with pytest.raises(ValueError, match="saved"):
            fe.launch_backward(bad, kv, dy.view(N, L, D), packed, *opts)
        with pytest.raises(ValueError, match="saved"):
            eb.Stages(bad, kv, dy.view(N, L, D), packed, HEADS, True, "gelu", RATE, RATE, SEED, 0)


def test_transposed_weights_layout():
    packed = _packed("gelu")
    wqkvo, w1, w2 = packed[0], packed[2], packed[4]
    flat = eb.transposed_weights_reference(packed)
    per = 4 * D * D + 2 * D * INNER
    assert flat.shape == (LAYERS * per,)
    for li in range(LAYERS):
        at = li * per
        wo = flat[at:at + D * D].view(D, D)
        w2t = flat[at + D * D:at + D * D + D * INNER].view(D, INNER)
        w1t = flat[at + D * D + D * INNER:at + D * D + 2 * D * INNER].view(INNER, D)
        wqkv = flat[at + D * D + 2 * D * INNER:at + per].view(3 * D, D)
        assert torch.equal(wo, wqkvo[li, 3].t()) and torch.equal(w2t, w2[li].t())
        assert torch.equal(w1t, w1[li].t())
        assert torch.equal(wqkv, torch.cat([wqkvo[li, m].t() for m in range(3)]))


def test_saved_layout_matches_the_forward():
    x, kv, _ = _inputs(7, empty=(1,))
    packed = _packed("relu")
    y, saved = eb.train_forward_reference(x, kv, packed, HEADS, True, "relu", EPS, RATE, RATE,
                                          SEED)
    assert saved.shape == (LAYERS, fe.saved_floats(N * L, D, INNER))
    views = eb.saved_views(saved, N * L, D, INNER)
    assert tuple(views[0]) == eb.SAVED_NAMES
    # the views tile each layer's floats in order, with nothing left over
    at = 0
    for name in eb.SAVED_NAMES:
        v = views[1][name]
        assert v.data_ptr() == saved[1].data_ptr() + 4 * at, name
        at += v.numel()
    assert at == saved.shape[1]
    # y is the plain forward's; layer 1's input is layer 0's output
    want = fe.fused_encoder_reference(x, kv, packed, HEADS, True, "relu", EPS, True, RATE, RATE,
                                      SEED)
    _assert_close(y, want, "y")
    one = [t[:1].contiguous() for t in packed]
    first = fe.fused_encoder_reference(x, kv, one, HEADS, True, "relu", EPS, True, RATE, RATE,
                                       SEED)
    _assert_close(views[1]["x"], first.reshape(N * L, D), "layer 1's input")


@pytest.mark.parametrize("rows", [1, 255, 256, 257, 600, 12 * 8, 51_200, 153_600, 1_000_003])
def test_wgrad_chunks_cover_every_row_once(rows):
    chunks = eb.wgrad_chunks(rows)
    assert chunks[0][0] == 0 and chunks[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    per = eb.wgrad_rows_per_chunk(rows)
    assert per % eb.ROW_TILE == 0 and per >= 256
    assert all(e - s == per for s, e in chunks[:-1]) and 0 < chunks[-1][1] - chunks[-1][0] <= per
    assert len(chunks) <= 64 or per == 256


def test_wgrad_chunks_depend_on_rows_alone():
    # the same N * L from other (N, L): the same chunks, so the same sums
    for shape_a, shape_b in (((1024, 50), (2048, 25)), ((3072, 50), (2400, 64)),
                             ((7, 12), (84, 1))):
        ra, rb = shape_a[0] * shape_a[1], shape_b[0] * shape_b[1]
        assert ra == rb and eb.wgrad_chunks(ra) == eb.wgrad_chunks(rb)
