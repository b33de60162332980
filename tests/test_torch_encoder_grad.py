"""The port's encoder gradients and dropout against the JAX package's.

At dropout 0 the port's gradients (``dx`` and the 8 packed arrays, through
the plain version on the CPU, ``fused_encoder`` under autograd) are held to
two JAX sources, with weights made by flax and carried across:

* ``jax.grad`` through the JAX ``fused_encoder`` in interpret mode, i.e. the
  Pallas ``_bwd_kernel`` (K4b), on inputs where every query row has a valid
  key (the TPU kernel spreads a row without one over its tile);
* ``jax.grad`` through the flax path (``REC_PANGU_TPU_FUSED_ENCODER=0``), on
  inputs with empty histories too.

Tolerance: float32 on both sides, the products and the LayerNorm statistics
summed in other orders (flax also takes LayerNorm's variance in one pass,
mean(x^2) - mean(x)^2, and LayerNorm's backward scales rounding by 1/std).
Each array (``dx`` and the 8 gradients, each a sum of many terms) within
rtol 1e-5 and an atol of 1e-5 times its largest entry (at least 1e-5):
cancellation leaves small entries with the rounding of the large terms
(seen: 1.0e-5 on an entry of 3.5e-3 whose array reaches 9.5).  With dropout on, the masks
(``dropout_scale``) are the documented hash, the same for the same seed and
other for another, keep 1 - p of the elements and scale them by 1 / (1 - p);
the blocks path and the packed plain version apply the same masks.  The CUDA
kernels run only on the card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.ops.kernels.fused_encoder import fused_encoder as jax_fused_encoder
from rec_pangu_tpu.ops.kernels.fused_encoder import pack_params
from rec_pangu_tpu.ops.sequence_enc import TransformerEncoder as JaxEncoder
from rec_pangu_tpu_torch.ops.kernels import fused_encoder as fe
from rec_pangu_tpu_torch.ops.sequence_enc import TransformerEncoder, draw_seed

N, L, D, HEADS, INNER, LAYERS, EPS = 8, 12, 8, 2, 16, 2, 1e-3
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(act, causal) for act in ("relu", "gelu", "swish") for causal in (True, False)]


def _inputs(seed, empty=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, L, D)).astype(np.float32)
    lens = rng.integers(1, L + 1, N)
    lens[list(empty)] = 0
    key_valid = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    co = rng.standard_normal((N, L, D)).astype(np.float32)
    return x, key_valid, co


def _flax_mask(key_valid, causal):
    ok = key_valid[:, None, None, :].astype(bool)
    if causal:
        ok = ok & np.tril(np.ones((L, L), bool))
    return jnp.where(ok, 0.0, -1e6)


def _jax_encoder(act):
    return JaxEncoder(n_layers=LAYERS, n_heads=HEADS, inner_size=INNER, hidden_dropout_prob=0.0,
                      attn_dropout_prob=0.0, hidden_act=act, layer_norm_eps=EPS)


def _params(x, key_valid, act, causal, seed):
    return _jax_encoder(act).init({"params": jax.random.PRNGKey(seed)}, x,
                                  _flax_mask(key_valid, causal), False)["params"]


def _port_grads(x, key_valid, co, packed, act, causal, **dropout):
    xt = torch.from_numpy(x).requires_grad_()
    pt = [torch.from_numpy(np.array(a)).requires_grad_() for a in packed]
    y = fe.fused_encoder(xt, torch.from_numpy(key_valid), pt, HEADS, causal, act, EPS, **dropout)
    (y * torch.from_numpy(co)).sum().backward()
    return xt.grad.numpy(), [t.grad.numpy() for t in pt]


def _assert_grads(got, want):
    for name, a, b in zip(("dx",) + fe.PACKED_NAMES, [got[0]] + list(got[1]),
                          [want[0]] + list(want[1])):
        b = np.asarray(b)
        atol = 1e-5 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("act,causal", CASES)
def test_grads_match_jax_kernel_interpret(act, causal, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
    x, key_valid, co = _inputs(1)  # no empty history: every row has a valid key
    jpacked = pack_params(_params(x, key_valid, act, causal, 3), LAYERS)

    def loss(p, xx):
        y = jax_fused_encoder(xx, p, jnp.asarray(key_valid), jnp.int32(0), LAYERS, HEADS, INNER,
                              0.0, 0.0, EPS, True, 4, True, causal, act)
        return jnp.vdot(y, jnp.asarray(co))

    g_packed, g_x = jax.grad(loss, argnums=(0, 1))(jpacked, jnp.asarray(x))
    got = _port_grads(x, key_valid, co, jpacked, act, causal, train=True)
    _assert_grads(got, (np.asarray(g_x), g_packed))


@pytest.mark.parametrize("act,causal", CASES)
def test_grads_match_flax_on_every_row(act, causal, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    x, key_valid, co = _inputs(2, empty=(2, 5))
    params = _params(x, key_valid, act, causal, 4)
    mask = _flax_mask(key_valid, causal)

    def loss(p, xx):
        return jnp.vdot(_jax_encoder(act).apply({"params": p}, xx, mask, False), jnp.asarray(co))

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    got = _port_grads(x, key_valid, co, pack_params(params, LAYERS), act, causal)
    _assert_grads(got, (np.asarray(g_x), pack_params(g_params, LAYERS)))


def test_packed_weights_carry_gradients_to_the_blocks():
    """``packed()`` is differentiable: gradients taken through the packed
    plain version (the card's route) reach the blocks' weights and equal the
    blocks path's, with dropout on."""
    x, key_valid, co = _inputs(3, empty=(4,))
    grads = []
    for packed_route in (False, True):
        enc = TransformerEncoder(D, LAYERS, HEADS, INNER, 0.2, 0.3, "gelu", EPS,
                                 torch.Generator().manual_seed(9))
        xt, kv = torch.from_numpy(x), torch.from_numpy(key_valid)
        if packed_route:
            y = fe.fused_encoder(xt, kv, enc.packed(), HEADS, True, "gelu", EPS, True, 0.2, 0.3,
                                 seed=11)
        else:
            y = enc(xt, kv, causal=True, train=True, seed=11)
        (y * torch.from_numpy(co)).sum().backward()
        grads.append({n: p.grad.clone() for n, p in enc.named_parameters()})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) == LAYERS * 16
    for name in grads[0]:
        np.testing.assert_allclose(grads[1][name].numpy(), grads[0][name].numpy(), **TOL,
                                   err_msg=name)


def _mix(x):
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


def test_dropout_masks_are_the_documented_hash():
    rng = np.random.default_rng(4)
    xs = [int(v) for v in rng.integers(0, 2 ** 32, 2000, dtype=np.uint64)] + [0, 2 ** 32 - 1]
    got = fe.mix32(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [_mix(v) for v in xs]
    seed, layer, site, rate = 12345, 1, fe.ATTN_OUT_SITE, 0.25
    masks = fe.dropout_scale(seed, 3, layer, site, (4, 5), rate)
    thr = int(rate * 2 ** 32)
    for n in range(3):
        key = _mix(_mix(_mix(seed ^ 0x9E3779B9) ^ n) ^ (3 * layer + site))
        for i in range(20):
            keep = _mix(key ^ _mix(i)) >= thr
            assert float(masks[n].reshape(-1)[i]) == (fe.drop_scale(rate) if keep else 0.0)


def test_dropout_masks_seed_share_and_scale():
    p = 0.1
    a = fe.dropout_scale(7, 1024, 0, fe.ATTN_SITE, (4, 32, 32), p)
    assert torch.equal(a, fe.dropout_scale(7, 1024, 0, fe.ATTN_SITE, (4, 32, 32), p))
    for other in (fe.dropout_scale(8, 1024, 0, fe.ATTN_SITE, (4, 32, 32), p),
                  fe.dropout_scale(7, 1024, 1, fe.ATTN_SITE, (4, 32, 32), p)):
        assert float((a != other).float().mean()) > 0.1  # another seed or layer: other masks
    kept = a > 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 1e-3
    scale = np.float32(1) / np.float32(1 - p)
    assert set(torch.unique(a).tolist()) == {0.0, float(scale)}
    assert fe.drop_threshold(0.0) == 0 and fe.drop_threshold(1 - 1e-12) == 2 ** 32 - 1
    with pytest.raises(ValueError, match="dropout rate"):
        fe.fused_encoder(torch.zeros(1, 2, 4), torch.ones(1, 2),
                         TransformerEncoder(4, 1, 2, 8).packed(), 2, hidden_dropout=1.0)


def test_masked_forward_equals_plain_version_fed_the_masks():
    """The dropout forward is the plain version with the masks applied where
    the flax block applies them; rate 0 or eval leaves the output as it is."""
    x, key_valid, _ = _inputs(5, empty=(1,))
    enc = TransformerEncoder(D, LAYERS, HEADS, INNER, 0.3, 0.2, "relu", EPS)
    xt, kv = torch.from_numpy(x), torch.from_numpy(key_valid)
    with torch.no_grad():
        blocks = enc(xt, kv, causal=False, train=True, seed=21)
        packed = fe.fused_encoder(xt, kv, enc.packed(), HEADS, False, "relu", EPS, True, 0.3, 0.2,
                                  seed=21)
        np.testing.assert_allclose(blocks.numpy(), packed.numpy(), **TOL)
        # by hand: each block with the masks of its layer
        y = xt
        add_mask = fe.additive_mask(kv, False)
        for li, block in enumerate(enc.blocks):
            y = block(y, add_mask, fe.layer_masks(21, N, li, L, D, HEADS, 0.3, 0.2))
        np.testing.assert_array_equal(y.numpy(), blocks.numpy())
        assert not torch.allclose(blocks, enc(xt, kv, causal=False, train=True, seed=22))
        assert not torch.allclose(blocks, enc(xt, kv, causal=False))
        plain = enc(xt, kv, causal=False)
        zero = TransformerEncoder(D, LAYERS, HEADS, INNER, 0.0, 0.0, "relu", EPS)
        zero.load_state_dict(enc.state_dict())
        np.testing.assert_array_equal(zero(xt, kv, causal=False, train=True, seed=21).numpy(),
                                      plain.numpy())
    seeds = {draw_seed(torch.Generator().manual_seed(0)) for _ in range(2)}
    assert len(seeds) == 1 and 0 <= seeds.pop() < 2 ** 31 - 1
