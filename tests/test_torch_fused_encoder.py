"""The port's transformer encoder against the JAX package's.

Weights are made by flax and carried across.  Two references:

* the flax path (``REC_PANGU_TPU_FUSED_ENCODER=0``), held on every row,
  including the rows of an empty history, which no key may be seen from;
* the JAX Pallas kernel K4f in interpret mode, held on the rows that have
  a valid key (the TPU kernel spreads a row with none over its tile's other
  samples; the port follows the flax path there).

Tolerance: atol 1e-5.  Both sides compute in float32; they sum the
products and the LayerNorm statistics in other orders (flax takes the
variance as mean(x^2) - mean(x)^2, the port as mean((x - mean)^2)).
The kernel itself runs only on the card (``chip_smoke.py``); on the CPU
the wrapper runs its plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.ops.kernels.fused_encoder import fused_encoder as jax_fused_encoder
from rec_pangu_tpu.ops.kernels.fused_encoder import pack_params
from rec_pangu_tpu.ops.sequence_enc import TransformerEncoder as JaxEncoder
from rec_pangu_tpu_torch.convert import jax_variables, load_jax_variables
from rec_pangu_tpu_torch.ops.kernels import fused_encoder as fe
from rec_pangu_tpu_torch.ops.sequence_enc import TransformerEncoder

N, L, D, HEADS, INNER, LAYERS, EPS = 16, 12, 8, 2, 16, 3, 1e-3
ATOL = 1e-5
CASES = [(act, causal) for act in ("relu", "gelu", "swish") for causal in (True, False)]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, L, D)).astype(np.float32)
    lens = rng.integers(1, L + 1, N)
    lens[[2, 9]] = 0  # empty histories: no valid key anywhere
    key_valid = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    return x, key_valid, lens


def _jax_encoder(act):
    return JaxEncoder(n_layers=LAYERS, n_heads=HEADS, inner_size=INNER,
                      hidden_dropout_prob=0.0, attn_dropout_prob=0.0, hidden_act=act,
                      layer_norm_eps=EPS)


def _flax_mask(key_valid, causal):
    ok = key_valid[:, None, None, :].astype(bool)
    if causal:
        ok = ok & np.tril(np.ones((L, L), bool))
    return jnp.where(ok, 0.0, -1e6)


def _port(params, act):
    enc = TransformerEncoder(D, LAYERS, HEADS, INNER, 0.0, 0.0, act, EPS)
    load_jax_variables(enc, {"params": jax.tree_util.tree_map(np.asarray, params)})
    return enc


def _params(x, key_valid, act, causal, seed=1):
    return _jax_encoder(act).init({"params": jax.random.PRNGKey(seed)}, x,
                                  _flax_mask(key_valid, causal), False)["params"]


@pytest.mark.parametrize("act,causal", CASES)
def test_encoder_matches_flax_on_every_row(inputs, act, causal, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ENCODER", "0")
    x, key_valid, _ = inputs
    params = _params(x, key_valid, act, causal)
    want = np.asarray(_jax_encoder(act).apply({"params": params}, x,
                                              _flax_mask(key_valid, causal), False))
    enc = _port(params, act)
    with torch.no_grad():
        got = enc(torch.from_numpy(x), key_valid=torch.from_numpy(key_valid),
                  causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the packed plain version computes the same, rows without a key included
    with torch.no_grad():
        packed = fe.fused_encoder(torch.from_numpy(x), torch.from_numpy(key_valid),
                                  enc.packed(), HEADS, causal, act, EPS).numpy()
    np.testing.assert_allclose(packed, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("act,causal", CASES)
def test_plain_version_matches_jax_kernel_interpret(inputs, act, causal, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
    x, key_valid, lens = inputs
    params = _params(x, key_valid, act, causal, seed=2)
    jpacked = pack_params(params, LAYERS)
    want = np.asarray(jax_fused_encoder(jnp.asarray(x), jpacked, jnp.asarray(key_valid),
                                        jnp.int32(0), LAYERS, HEADS, INNER, 0.0, 0.0, EPS,
                                        False, 4, True, causal, act))
    packed = [torch.from_numpy(np.array(a)) for a in jpacked]
    got = fe.fused_encoder(torch.from_numpy(x), torch.from_numpy(key_valid), packed,
                           HEADS, causal, act, EPS).numpy()
    # a query row has a valid key when its sample's history is not empty
    # (causal: key 0 is valid and precedes every query)
    rows = lens > 0
    assert rows.sum() == N - 2
    np.testing.assert_allclose(got[rows], want[rows], rtol=0, atol=ATOL)
    # the encoder packs its weights exactly as the JAX package's pack_params
    for mine, theirs in zip(_port(params, act).packed(), jpacked):
        np.testing.assert_array_equal(mine.detach().numpy(), np.asarray(theirs))


def test_weights_round_trip_to_the_jax_layout(inputs):
    x, key_valid, _ = inputs
    params = _params(x, key_valid, "gelu", True)
    back = jax_variables(_port(params, "gelu"))
    assert back["batch_stats"] is None
    jax.tree_util.tree_map(np.testing.assert_array_equal, back["params"],
                           jax.tree_util.tree_map(np.asarray, dict(params)))


def test_shapes_the_kernel_does_not_take_raise():
    fe.check_supported(50, 64, 32, 2)   # the bench shape
    fe.check_supported(1, 8, 32, 1)
    for bad in ((65, 64, 32, 2), (50, 129, 32, 2), (50, 64, 257, 2), (0, 64, 32, 2),
                (50, 64, 32, 0)):
        with pytest.raises(ValueError, match="fused encoder kernel takes"):
            fe.check_supported(*bad)
    x = torch.zeros(2, 4, 8)
    kv = torch.ones(2, 4)
    packed = TransformerEncoder(8, 1, 2, 16).packed()
    with pytest.raises(ValueError, match="divisible"):
        fe.fused_encoder(x, kv, packed, 3)
    with pytest.raises(ValueError, match="activation"):
        fe.fused_encoder(x, kv, packed, 2, act="tanh")
    with pytest.raises(ValueError, match="key_valid"):
        fe.fused_encoder(x, kv[:, :3], packed, 2)
    with pytest.raises(ValueError, match="b2 must be"):
        fe.fused_encoder(x, kv, packed[:5] + (packed[5][..., :3],) + packed[6:], 2)
    with pytest.raises(ValueError, match="no fused encoder kernel for device"):
        fe.fused_encoder(x.to("meta"), kv.to("meta"), [t.to("meta") for t in packed], 2)


def test_dropout_in_training_waits_for_the_training_slice(inputs):
    """Dropout in training arrived with the training slice: a training call
    drops with the masks of its seed; eval and rate 0 do not; a rate
    outside [0, 1) still raises."""
    x, key_valid, _ = inputs
    enc = TransformerEncoder(D, 1, HEADS, INNER, 0.1, 0.1)
    xt, kv = torch.from_numpy(x), torch.from_numpy(key_valid)
    with torch.no_grad():
        y = enc(xt, train=True, key_valid=kv, seed=5)
        assert y.shape == (N, L, D)
        assert torch.equal(y, enc(xt, train=True, key_valid=kv, seed=5))
        assert not torch.allclose(y, enc(xt, train=False, key_valid=kv))
        packed = fe.fused_encoder(xt, kv, enc.packed(), HEADS, True, "gelu", 1e-12, True, 0.1,
                                  0.1, 5)
        np.testing.assert_allclose(packed.numpy(), y.numpy(), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="dropout rate"):
        TransformerEncoder(D, 1, HEADS, INNER, 1.0, 0.1)


# the kernel's launch plan (rp_fused_encoder_plan computes the same on the
# card; chip_smoke.py holds the two equal)
BENCH_SHAPES = {"sasrec": (50, 64, 32, 4), "iocrec": (50, 64, 128, 2), "bert4rec": (50, 64, 64, 2)}
SM_SHARED = 233_472  # an H100 SM's shared memory; a block also takes 1 KB of it


@pytest.mark.parametrize("name", sorted(BENCH_SHAPES))
def test_launch_plan_at_the_bench_shapes(name):
    """One sample a block, 224 threads (13 row tiles of 16 threads, in whole
    warps), two heads' scores a pass, and two blocks an SM."""
    plan = fe.launch_plan(*BENCH_SHAPES[name])
    assert plan == fe.LaunchPlan(samples=1, threads=224, smem_bytes=108_176, heads=2)
    assert 2 * (plan.smem_bytes + 1024) <= SM_SHARED


def test_launch_plan_fits_every_shape_the_kernel_takes():
    """Shared memory grows with L, D and inner, so inner = 4 D bounds each
    (L, D); threads cover 16 a 4-row tile, in whole warps, at most 256; an
    attention pass holds at least one head, all of them where they fit."""
    worst = 0
    for L in range(1, fe.MAX_L + 1):
        for D in range(1, fe.MAX_D + 1):
            for heads in (1, D):
                plan = fe.launch_plan(L, D, 4 * D, heads)
                assert plan.samples == 1 and 1 <= plan.heads <= heads
                assert plan.threads % 32 == 0 and 16 * ((L + 3) // 4) <= plan.threads <= 256
                worst = max(worst, plan.smem_bytes)
    assert worst <= fe.SMEM_LIMIT
    for inner in (1, 31, 32, 33, 127, 128, 256):
        assert (fe.launch_plan(50, 64, inner, 4).smem_bytes
                <= fe.launch_plan(50, 64, 256, 4).smem_bytes)
    # the widest rows leave room for two heads' scores, in one block an SM
    assert fe.launch_plan(fe.MAX_L, fe.MAX_D, 4 * fe.MAX_D, 4).heads == 2
    with pytest.raises(ValueError, match="fused encoder kernel takes"):
        fe.launch_plan(65, 64, 32, 4)
    with pytest.raises(ValueError, match="divisible"):
        fe.launch_plan(50, 64, 32, 3)


@pytest.mark.parametrize("act,causal", CASES)
def test_training_forward_with_rates_zero_is_the_serving_forward(inputs, act, causal):
    """The contract that lets one kernel serve both modes: with both
    dropout rates 0 the training forward is the serving forward, bit for
    bit, with and without a gradient."""
    x, key_valid, _ = inputs
    enc = TransformerEncoder(D, LAYERS, HEADS, INNER, 0.0, 0.0, act, EPS)
    packed = [t.detach() for t in enc.packed()]
    xt, kv = torch.from_numpy(x), torch.from_numpy(key_valid)
    with torch.no_grad():
        serving = fe.fused_encoder(xt, kv, packed, HEADS, causal, act, EPS)
        training = fe.fused_encoder(xt, kv, packed, HEADS, causal, act, EPS, True, 0.0, 0.0, 5)
    assert torch.equal(serving, training)
    xs = xt.clone().requires_grad_()
    graded = fe.fused_encoder(xs, kv, [t.clone().requires_grad_() for t in packed], HEADS,
                              causal, act, EPS, True, 0.0, 0.0, 5)
    assert torch.equal(serving, graded.detach())
