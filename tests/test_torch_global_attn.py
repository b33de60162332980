"""The port's global-attention encoder (K6's plain version) against the JAX
package's.

Weights made by flax and carried across; inputs from a numpy seed.  The
forward and every gradient (dx, wk, bk, wv, bv, q_s) are held to two JAX
sources, dropout off: the Pallas kernels (``global_attn`` in interpret mode,
``_fwd_kernel`` and ``_bwd_kernel``) and the flax path of
``GlobalSeqEncoder``.  Tolerance: float32 on both sides, summed in other
orders; each array within rtol 1e-5 and an atol of 1e-5 times its largest
entry (at least 1e-5).  The key bias has an exact gradient of 0 (a softmax
does not change when a row of scores moves by one constant): both sides
hold rounding noise there (seen: 1.9e-6), held within 1e-5 of 0.  The dropout masks
are the fused encoder's hash on a stream of their own.  The CUDA kernels
run only on the card (``chip_smoke.py``).  The comparison with the Pallas
kernels runs at the shapes the card checks K6b at, beside the small one: odd
sizes (N=7, L=13, D=24), the largest the kernels take (L=64, D=128), and L=64
at D=64, where the forward's two variants meet the backward's streamed one,
each with a tile of samples that divides N.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models.sequence.iocrec import GlobalSeqEncoder as JaxGlobalSeqEncoder
from rec_pangu_tpu.ops.kernels.global_attn import global_attn as jax_global_attn
from rec_pangu_tpu_torch.convert import load_jax_variables
from rec_pangu_tpu_torch.models.sequence.iocrec import GlobalSeqEncoder
from rec_pangu_tpu_torch.ops.kernels import fused_encoder as fe
from rec_pangu_tpu_torch.ops.kernels import global_attn as ga

N, L, D = 8, 10, 16
NAMES = ("dx", "wk", "bk", "wv", "bv", "q_s")


def _inputs(seed, n=N, length=L, dim=D):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, length, dim)).astype(np.float32)
    co = rng.standard_normal((n, length, dim)).astype(np.float32)
    return x, co


def _make_flax_params(length=L, dim=D):
    enc = JaxGlobalSeqEncoder(max_len=length, dropout=0.5)
    x, _ = _inputs(0, 2, length, dim)
    params = enc.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(x), False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    # nonzero biases, so that every term counts
    rng = np.random.default_rng(9)
    for name in ("K_linear", "V_linear"):
        params[name]["bias"] = (rng.standard_normal(dim) * 0.1).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def flax_params():
    return _make_flax_params()


def _packed(p):
    return (p["K_linear"]["kernel"], p["K_linear"]["bias"], p["V_linear"]["kernel"],
            p["V_linear"]["bias"], p["Q_s"])


def _port_grads(x, co, params):
    xt = torch.from_numpy(x).requires_grad_()
    pt = [torch.from_numpy(np.array(a)).requires_grad_() for a in params]
    y = ga.global_attn(xt, pt)
    (y * torch.from_numpy(co)).sum().backward()
    return y.detach().numpy(), [xt.grad.numpy()] + [t.grad.numpy() for t in pt]


def _assert_close(got, want, names):
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        if name == "bk":  # an exact gradient of 0: rounding noise on both sides
            assert max(np.abs(a).max(), np.abs(b).max()) < 1e-5, name
            continue
        atol = 1e-5 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("n,length,dim,tb",
                         [(N, L, D, 4), (7, 13, 24, 7), (3, 64, 128, 3), (5, 64, 64, 5)])
def test_matches_jax_kernels_interpret(n, length, dim, tb):
    flax_p = _make_flax_params(length, dim)
    x, co = _inputs(1, n, length, dim)
    params = tuple(jnp.asarray(a) for a in _packed(flax_p))

    def run(xx, p):
        return jax_global_attn(xx, p, jnp.int32(0), 0.0, False, tb, True)

    def loss(xx, p):
        return jnp.vdot(run(xx, p), jnp.asarray(co))

    want_y = np.asarray(run(jnp.asarray(x), params))
    g_x, g_p = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), params)
    y, grads = _port_grads(x, co, _packed(flax_p))
    np.testing.assert_allclose(y, want_y, rtol=1e-5, atol=1e-5)
    _assert_close(grads, [g_x] + list(g_p), NAMES)


def test_module_matches_flax_path(flax_params, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    x, co = _inputs(2)
    enc = JaxGlobalSeqEncoder(max_len=L, dropout=0.5)

    def loss(p, xx):
        return jnp.vdot(enc.apply({"params": p}, xx, False), jnp.asarray(co))

    want_y = np.asarray(enc.apply({"params": flax_params}, jnp.asarray(x), False))
    g_p, g_x = jax.grad(loss, argnums=(0, 1))(flax_params, jnp.asarray(x))
    module = GlobalSeqEncoder(L, D, 0.5, torch.Generator().manual_seed(0))
    load_jax_variables(module, {"params": flax_params})
    xt = torch.from_numpy(x).requires_grad_()
    y = module(xt, train=False)
    (y * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5, atol=1e-5)
    got = [xt.grad.numpy()] + [t.grad.numpy() for t in module.params()]
    want = [g_x, g_p["K_linear"]["kernel"], g_p["K_linear"]["bias"], g_p["V_linear"]["kernel"],
            g_p["V_linear"]["bias"], g_p["Q_s"]]
    _assert_close(got, want, NAMES)


def test_dropout_masks(flax_params):
    rate = 0.5
    x = torch.from_numpy(_inputs(3)[0])
    params = [torch.from_numpy(np.array(a)) for a in _packed(flax_params)]
    plain = ga.global_attn(x, params)
    y1, y2, y3 = (ga.global_attn(x, params, seed, rate, train=True) for seed in (5, 5, 6))
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    mask = ga.output_mask(5, N, L, D, rate)
    torch.testing.assert_close(y1, plain * mask, rtol=0, atol=0)
    # without train the rate is ignored
    assert torch.equal(ga.global_attn(x, params, 5, rate, train=False), plain)
    big = ga.output_mask(11, 4096, L, D, rate)
    keep = float((big > 0).float().mean())
    assert abs(keep - (1 - rate)) < 5e-3
    assert torch.all((big == 0) | (big == fe.drop_scale(rate)))
    # its own stream: not the fused encoder's layer-0 sites, not IOCRec's input site
    for other in (fe.dropout_scale(5, N, 0, site, (L, D), rate) for site in range(3)):
        assert not torch.equal(other, mask)
    input_mask = fe.dropout_scale(5, N, ga.DROPOUT_LAYER, ga.INPUT_SITE, (L, D), rate)
    assert not torch.equal(input_mask, mask)


def test_rejects_bad_inputs(flax_params):
    x = torch.from_numpy(_inputs(4)[0])
    params = [torch.from_numpy(np.array(a)) for a in _packed(flax_params)]
    with pytest.raises(ValueError, match="q_s must be"):
        ga.global_attn(x[:, :5], params)
    with pytest.raises(ValueError, match="params must be"):
        ga.global_attn(x, params[:4])
    with pytest.raises(ValueError, match="dropout rate"):
        ga.global_attn(x, params, 0, 1.0, True)
    with pytest.raises(ValueError, match="L <= 64"):
        ga.check_supported(65, D)


def test_cpu_builds_and_launches_nothing(flax_params, monkeypatch):
    from rec_pangu_tpu_torch.ops.kernels import _build

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU call built a kernel")

    monkeypatch.setattr(_build, "build_all", no_build)
    x = torch.from_numpy(_inputs(5)[0]).requires_grad_()
    params = [torch.from_numpy(np.array(a)).requires_grad_() for a in _packed(flax_params)]
    ga.global_attn(x, params, 3, 0.5, True).sum().backward()
    assert ga.LAUNCHES == ga.BACKWARD_LAUNCHES == 0 and ga._FWD_FN is None
