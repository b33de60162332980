"""The ranking zoo's layers against the JAX package's, the kernels' shape
routes, the MLP's dropout masks and the ranking steps' seeds.

Each layer is built by both packages at a small size (batch 16, 6 fields,
D 8), the port loads the flax variables (``load_jax_variables``) and the
outputs agree within 1e-5.  ``kmax_pooling`` is held on integer data full
of ties.  The routes: each kernel module's ``kernel_takes`` at and just past
each limit, and a call on a shape past a limit takes the plain version
(the device check sees the card, the launchers raise), one at the limit
the kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models.ranking.aoanet import (GeneralizedInteraction as
                                                 JaxGeneralizedInteraction)
from rec_pangu_tpu.ops import attention as jattention
from rec_pangu_tpu.ops import conv as jconv
from rec_pangu_tpu.ops import interactions as jint
from rec_pangu_tpu.ops.pooling import kmax_pooling as jax_kmax_pooling
from rec_pangu_tpu_torch.convert import load_jax_variables
from rec_pangu_tpu_torch.data import DataLoader
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.models.ranking.aoanet import GeneralizedInteraction
from rec_pangu_tpu_torch.ops import attention, conv, interactions, sequence_enc
from rec_pangu_tpu_torch.ops.dropout import mlp_stream
from rec_pangu_tpu_torch.ops.kernels import fused_encoder as fenc
from rec_pangu_tpu_torch.ops.kernels import global_attn as gattn
from rec_pangu_tpu_torch.ops.kernels import multimax_ce as mmce
from rec_pangu_tpu_torch.ops.mlp import MLP
from rec_pangu_tpu_torch.ops.pooling import kmax_pooling
from rec_pangu_tpu_torch.ops.sequence_enc import TransformerEncoder
from rec_pangu_tpu_torch.train import RankTrainer
from rec_pangu_tpu_torch.train.fused_update import maybe_enable_fused_update

B, F, D = 16, 6, 8
ATOL = 1e-5


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cases():
    emb = _x(B, F, D)
    flat = _x(B, F * D + 2, seed=1)
    b4 = _x(B, 4, D, seed=2)
    return {
        "CrossNet": (jint.CrossNet(3), interactions.CrossNet(F * D + 2, 3), (flat,)),
        "CIN": (jint.CompressedInteractionNet(F, (4, 3), 1),
                interactions.CompressedInteractionNet(F, (4, 3), 1), (emb,)),
        "SENET": (jint.SENETLayer(3), interactions.SENETLayer(F, 3), (emb,)),
        "Bilinear-field_all": (jint.BilinearInteraction("field_all"),
                               interactions.BilinearInteraction(F, D, "field_all"), (emb,)),
        "Bilinear-field_each": (jint.BilinearInteraction("field_each"),
                                interactions.BilinearInteraction(F, D, "field_each"), (emb,)),
        "Bilinear-field_interaction": (
            jint.BilinearInteraction("field_interaction"),
            interactions.BilinearInteraction(F, D, "field_interaction"), (emb,)),
        "MaskBlock": (jint.MaskBlock(24, 0.3), interactions.MaskBlock(F * D + 2, F * D + 2, 24,
                                                                      0.3),
                      (flat, flat * 0.5)),
        "CCPMConvLayer": (jconv.CCPMConvLayer(F, (4, 4, 2), (6, 5, 3)),
                          conv.CCPMConvLayer(F, (4, 4, 2), (6, 5, 3)), (emb,)),
        "GeneralizedInteraction-first": (
            JaxGeneralizedInteraction(F, 4, F, D),
            GeneralizedInteraction(F, 4, F, D, torch.Generator()), (emb, emb)),
        "GeneralizedInteraction-later": (
            JaxGeneralizedInteraction(4, 4, F, D),
            GeneralizedInteraction(4, 4, F, D, torch.Generator()), (emb, b4)),
        "MultiHeadSelfAttention-autoint": (
            jattention.MultiHeadSelfAttention(attention_dim=4, num_heads=2, align_to="output"),
            attention.MultiHeadSelfAttention(D, 4, 2, align_to="output"), (emb,)),
        "MultiHeadSelfAttention-scaled-ln": (
            jattention.MultiHeadSelfAttention(num_heads=2, use_scale=True, layer_norm=True),
            attention.MultiHeadSelfAttention(D, None, 2, use_scale=True, layer_norm=True),
            (emb,)),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_layer_matches_jax(case):
    jmod, mod, inputs = _cases()[case]
    jin = [jnp.asarray(x) for x in inputs]
    variables = _np(dict(jmod.init(jax.random.PRNGKey(3), *jin)))
    want = np.asarray(jmod.apply(variables, *jin))
    load_jax_variables(mod, variables)
    got = mod(*(torch.from_numpy(x) for x in inputs)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_attention_masked_rows_match_jax():
    """A boolean mask keeps True; a row with every key dropped is uniform
    over its keys (-1e6, not -inf), as in the JAX package; a float mask is
    added."""
    q, k, v = (_x(2, 3, 5, 4, seed=s) for s in (4, 5, 6))
    keep = np.random.default_rng(7).random((2, 3, 5, 5)) < 0.5
    keep[0, 0, 1] = False  # one row with no key at all
    add = np.where(keep, 0.0, -1e6).astype(np.float32)
    for mask in (keep, add):
        want, want_att = jattention.scaled_dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2.0, jnp.asarray(mask))
        got, got_att = attention.scaled_dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 2.0,
            torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
        np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att), rtol=0, atol=ATOL)
        if mask.dtype == bool:
            np.testing.assert_allclose(got_att[0, 0, 1].numpy(), np.full(5, 0.2), atol=1e-7)


@pytest.mark.parametrize("k,axis", [(1, 1), (3, 1), (5, 1), (2, 2), (4, 2), (9, 1)])
def test_kmax_pooling_with_ties_matches_jax(k, axis):
    x = np.random.default_rng(8).integers(0, 4, (5, 7, 6, 2)).astype(np.float32)
    x[0, :, 0, 0] = 2.0  # a whole column tied
    want = np.asarray(jax_kmax_pooling(jnp.asarray(x), k, axis))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = kmax_pooling(tx, k, axis)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # the gradient reaches the kept positions only, the ties' earlier ones
    w = _x(*want.shape, seed=9)
    (got * torch.from_numpy(w)).sum().backward()
    want_grad = jax.grad(lambda v: jnp.sum(jax_kmax_pooling(v, k, axis) * w))(jnp.asarray(x))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want_grad))


# ---------------------------------------------------------------- routes


@pytest.mark.parametrize("shape,takes", [
    ((64, 128, 512, 1), True), ((65, 64, 32, 2), False), ((50, 129, 32, 2), False),
    ((50, 64, 256, 2), True), ((50, 64, 257, 2), False), ((100, 64, 32, 2), False),
    ((50, 256, 32, 2), False), ((1, 1, 1, 1), True), ((50, 64, 32, 0), False)])
def test_fused_encoder_kernel_takes(shape, takes):
    assert fenc.kernel_takes(*shape) is takes
    if not takes:
        with pytest.raises(ValueError, match="takes"):
            fenc.check_supported(*shape)


@pytest.mark.parametrize("K,D_,takes", [(4, 128, True), (5, 64, False), (8, 64, False),
                                         (4, 129, False), (1, 1, True)])
def test_multimax_kernel_takes(K, D_, takes):
    assert mmce.kernel_takes(K, D_) is takes
    if not takes:
        with pytest.raises(ValueError, match="take"):
            mmce.check_supported(K, D_)


@pytest.mark.parametrize("L,D_,takes", [(64, 128, True), (65, 64, False), (80, 64, False),
                                         (50, 129, False), (1, 1, True)])
def test_global_attn_kernel_takes(L, D_, takes):
    assert gattn.kernel_takes(L, D_) is takes
    if not takes:
        with pytest.raises(ValueError, match="take"):
            gattn.check_supported(L, D_)


def _raise(*args, **kwargs):
    raise RuntimeError("the kernel was launched")


def _as_card(module, monkeypatch, name="routes_to_kernel", owner=None):
    """The route decided as on the card, for CPU tensors."""
    real = getattr(module, "routes_to_kernel")
    monkeypatch.setattr(owner or module, name,
                        lambda device, *shape: real(torch.device("cuda"), *shape))


@pytest.mark.parametrize("L,D_,inner", [(100, 32, 64), (20, 160, 64), (20, 32, 160)])
def test_encoder_past_its_limits_runs_the_plain_blocks(L, D_, inner, monkeypatch):
    enc = TransformerEncoder(D_, 2, 2, inner, 0.1, 0.1, "gelu")
    x = torch.from_numpy(_x(3, L, D_))
    kv = torch.ones(3, L)
    kv[0, L // 2:] = 0
    want, want_eval = enc(x, kv, train=True, seed=5), enc(x, kv)
    _as_card(fenc, monkeypatch, owner=sequence_enc)
    monkeypatch.setattr(sequence_enc, "fused_encoder", _raise)
    monkeypatch.setattr(fenc, "PLAIN_ROUTE", 0)
    got = enc(x, kv, train=True, seed=5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fenc.PLAIN_ROUTE == 1
    # the same wrapper called directly routes by the shape too
    _as_card(fenc, monkeypatch)
    monkeypatch.setattr(fenc, "launch", _raise)
    monkeypatch.setattr(fenc, "launch_train", _raise)
    y = fenc.fused_encoder(x, kv, enc.packed(), 2, True, "gelu", 1e-12)
    torch.testing.assert_close(y, want_eval, rtol=0, atol=ATOL)
    assert fenc.PLAIN_ROUTE == 2


def test_encoder_within_its_limits_takes_the_kernel(monkeypatch):
    enc = TransformerEncoder(64, 2, 2, 256, 0.0, 0.0, "gelu")
    _as_card(fenc, monkeypatch, owner=sequence_enc)
    monkeypatch.setattr(sequence_enc, "fused_encoder", _raise)
    monkeypatch.setattr(fenc, "PLAIN_ROUTE", 0)
    with pytest.raises(RuntimeError, match="launched"):
        enc(torch.zeros(2, 64, 64), torch.ones(2, 64))
    assert fenc.PLAIN_ROUTE == 0


@pytest.mark.parametrize("K,D_,routed", [(8, 16, False), (2, 136, False), (4, 16, True)])
def test_multimax_routes_by_shape(K, D_, routed, monkeypatch):
    u = torch.from_numpy(_x(5, K, D_))
    items = torch.from_numpy(_x(300, D_, seed=1))
    want_lse = mmce.multimax_lse(u, items, 290, True)
    want = mmce.multimax_grads(u, items, want_lse, 290, True)
    _as_card(mmce, monkeypatch)
    monkeypatch.setattr(mmce, "launch_lse", _raise)
    monkeypatch.setattr(mmce, "launch_grads", _raise)
    monkeypatch.setattr(mmce, "PLAIN_ROUTE", 0)
    if routed:
        with pytest.raises(RuntimeError, match="launched"):
            mmce.multimax_lse(u, items, 290, True)
        with pytest.raises(RuntimeError, match="launched"):
            mmce.multimax_grads(u, items, want_lse, 290, True)
        assert mmce.PLAIN_ROUTE == 0
        return
    torch.testing.assert_close(mmce.multimax_lse(u, items, 290, True), want_lse,
                               rtol=0, atol=0)
    for got, w in zip(mmce.multimax_grads(u, items, want_lse, 290, True), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    assert mmce.PLAIN_ROUTE == 2


@pytest.mark.parametrize("L,D_,routed", [(80, 16, False), (20, 136, False), (64, 16, True)])
def test_global_attn_routes_by_shape(L, D_, routed, monkeypatch):
    x = torch.from_numpy(_x(3, L, D_)).requires_grad_(True)
    params = [torch.from_numpy(a) for a in (_x(D_, D_, seed=1), _x(D_, seed=2),
                                            _x(D_, D_, seed=3), _x(D_, seed=4),
                                            _x(L, D_, seed=5))]
    want = gattn.global_attn(x, params, seed=7, rate=0.5, train=True)
    _as_card(gattn, monkeypatch)
    monkeypatch.setattr(gattn, "launch_forward", _raise)
    monkeypatch.setattr(gattn._GlobalAttn, "apply", _raise)
    monkeypatch.setattr(gattn, "PLAIN_ROUTE", 0)
    if routed:
        with pytest.raises(RuntimeError, match="launched"):
            gattn.global_attn(x, params, seed=7, rate=0.5, train=True)
        assert gattn.PLAIN_ROUTE == 0
        return
    got = gattn.global_attn(x, params, seed=7, rate=0.5, train=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.sum().backward()  # the plain route keeps its autograd
    assert x.grad is not None and gattn.PLAIN_ROUTE == 1


# ---------------------------------------------------------------- dropout


def test_mlp_dropout_is_the_hash_mask_of_its_stream():
    mlp = MLP(12, (16, 8), output_dim=1, dropout_rates=0.5)
    x = torch.from_numpy(_x(64, 12))
    a, b = mlp(x, True, seed=11), mlp(x, True, seed=11)
    torch.testing.assert_close(a, b, rtol=0, atol=0)          # equal seeds, equal masks
    assert not torch.equal(a, mlp(x, True, seed=12))
    torch.testing.assert_close(mlp(x), mlp(x, False, seed=11), rtol=0, atol=0)
    # layer 0's masks are the hash of (seed, sample, stream, element)
    h = torch.relu(mlp.dense[0](x))
    scale = fenc.dropout_scale(11, 64, *mlp_stream(0, 0), (16,), 0.5)
    assert 0.35 < float((scale == 0).float().mean()) < 0.65
    other = MLP(12, (16, 8), output_dim=1, dropout_rates=0.5, dropout_stream=1)
    other.load_state_dict(mlp.state_dict())
    assert not torch.equal(other(x, True, seed=11), a)         # another stream
    h2 = torch.relu(mlp.dense[1](h * scale))
    scale2 = fenc.dropout_scale(11, 64, *mlp_stream(0, 1), (8,), 0.5)
    torch.testing.assert_close(mlp.dense[2](h2 * scale2), a, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="streams hold"):
        mlp_stream(0, 16)


def _enc_dict(vocab=40, fields=3, dense=2):
    enc = {f"s{f}": {"vocab_size": vocab} for f in range(fields)}
    enc.update({f"d{d}": {"min": 0.0, "max": 1.0} for d in range(dense)})
    return enc


class _Arrays:
    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays["sparse"])


def _loader(rows=256, vocab=40, fields=3, dense=2, seed=0, batch=64):
    rng = np.random.default_rng(seed)
    arrays = {"sparse": rng.integers(0, vocab + 1, (rows, fields)).astype(np.int32),
              "dense": rng.random((rows, dense)).astype(np.float32),
              "label": rng.integers(0, 2, rows).astype(np.float32)}
    return DataLoader(_Arrays(arrays), batch_size=batch)


@pytest.mark.parametrize("fused", [True, False])
def test_fit_draws_dropout_from_its_seed(fused, tmp_path, monkeypatch):
    """xDeepFM (dropout 0.1): the same fit seed gives the same losses and
    weights, another seed other ones, on the fused and the standard step."""
    if not fused:
        monkeypatch.setenv("REC_PANGU_TPU_FUSED_ADAM", "0")

    def fit(seed):
        model = get_model("xDeepFM")(enc_dict=_enc_dict(), embedding_dim=4,
                                     dnn_hidden_units=(8,), cin_layer_units=(3,), seed=3)
        trainer = RankTrainer(device="cpu", model_ckpt_dir=str(tmp_path / str(seed)))
        torch.manual_seed(seed * 7)  # torch's own generator must not matter
        trainer.fit(model, _loader(), epoch=1, seed=seed, log_rounds=10 ** 9)
        assert trainer._train_step.fused is fused
        return torch.cat([p.detach().reshape(-1) for p in model.parameters()])

    torch.testing.assert_close(fit(5), fit(5), rtol=0, atol=0)
    assert not torch.equal(fit(5), fit(6))


# ---------------------------------------------------------------- tables


def test_lr_uploads_without_an_embedding_attribute():
    model = get_model("LR")(enc_dict=_enc_dict())
    assert not hasattr(model, "embedding")
    batch = next(iter(_loader()))
    inputs = model.upload_batch(batch, torch.device("cpu"), train=True)
    assert set(inputs) == {"sparse", "dense", "label"}
    assert model.lr_layer.embedding.table.shape == (3 * 41, 1)
    bad = dict(batch, sparse=batch["sparse"] + 41)
    with pytest.raises(ValueError, match="out of range"):
        model.upload_batch(bad, torch.device("cpu"))
    step = maybe_enable_fused_update(model, 1e-3, 1)
    before = model.lr_layer.embedding.table.detach().clone()
    step(inputs, 0)
    assert not torch.equal(before, model.lr_layer.embedding.table.detach())


def test_fm_fused_step_with_only_a_table():
    model = get_model("FM")(enc_dict=_enc_dict(), embedding_dim=4)
    step = maybe_enable_fused_update(model, 1e-3, 1)
    assert step.optimizer is None and len(step.tables) == 1
    before = model.embedding.table.detach().clone()
    step(model.upload_batch(next(iter(_loader())), torch.device("cpu"), train=True), 0)
    assert not torch.equal(before, model.embedding.table.detach())
    assert list(step.opt_state(1)["tables"]) == ["FusedEmbedding_0/table"]


class _LooksUpTwice(torch.nn.Module):
    """AFN with its second table looked up once more: the fused step must
    refuse it before any weight, moment or running statistic changes."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, batch, train=False, capture=None, seed=None):
        self.inner.embedding2(batch["sparse"], capture)
        return self.inner(batch, train, capture, seed)

    def jax_leaves(self):
        return self.inner.jax_leaves()


def test_fused_step_refuses_a_table_looked_up_twice():
    model = _LooksUpTwice(get_model("AFN")(enc_dict=_enc_dict(), embedding_dim=4,
                                           dnn_hidden_units=(8,), afn_hidden_units=(8,)))
    step = maybe_enable_fused_update(model, 1e-3, 1)
    assert [name for name, _ in step.tables] == ["inner.embedding", "inner.embedding2"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    inputs = model.inner.upload_batch(next(iter(_loader())), torch.device("cpu"), train=True)
    with pytest.raises(ValueError, match="exactly one lookup of each table"):
        step(inputs, 0)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    assert all(float(mu.abs().sum()) == 0 for mu, _ in step.moments)
