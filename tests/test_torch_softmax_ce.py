"""The port's streamed softmax CE against the JAX package's.

Two JAX references, the same inputs made with numpy:

* ``full_softmax_ce`` over ``output_items()``-style items (row 0 zeroed) on
  its naive path, below 65,536 items: the port's naive path and its streamed
  form (small chunks, so the online logsumexp crosses chunks);
* ``fused_softmax_ce_padded`` over a table of 70,000 items padded to 73,728
  rows: the port's padded form, at its own chunk and at 8192.

Covered: a target of 0, the pad rows (no gradient), row 0 (logit 0, no
gradient).  Loss within rtol 1e-6; ``d_user`` and the item gradient within
rtol 1e-5 and an atol of 1e-5 times the array's largest entry (float32 sums
of thousands of terms in other orders).  The captured variant's dense
gradient is the padded variant's table gradient, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.ops import softmax_ce as jce
from rec_pangu_tpu_torch.ops import softmax_ce as ce

B, D = 16, 8


def _close(got, want, what):
    want = np.asarray(want)
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


def _case(seed, vocab, rows):
    rng = np.random.default_rng(seed)
    user = rng.standard_normal((B, D)).astype(np.float32)
    table = (rng.standard_normal((rows, D)) * 0.5).astype(np.float32)
    pos = rng.integers(1, vocab, B).astype(np.int32)
    pos[3] = 0  # a padding target: its positive term gets no gradient
    return user, table, pos


def _port(fn, user, table, pos, **kw):
    u = torch.from_numpy(user).requires_grad_()
    t = torch.from_numpy(table.copy()).requires_grad_()
    loss = fn(u, t, torch.from_numpy(pos), **kw)
    loss.backward()
    return float(loss), u.grad.numpy(), t.grad.numpy()


@pytest.mark.parametrize("streamed", [False, True])
def test_small_corpus_matches_jax_naive_path(streamed, monkeypatch):
    vocab = 200
    user, table, pos = _case(0, vocab, vocab)
    zero0 = (np.arange(vocab) != 0)[:, None].astype(np.float32)

    def jloss(u, t):
        return jce.full_softmax_ce(u, t * zero0, jnp.asarray(pos))

    assert vocab < jce._FUSED_MIN_VOCAB  # the JAX side takes its naive path
    want = jloss(jnp.asarray(user), jnp.asarray(table))
    g_u, g_t = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(user), jnp.asarray(table))
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_CE", "1" if streamed else "auto")
    if streamed:
        monkeypatch.setattr(ce, "CHUNK_V", 64)  # four chunks, the last ragged
    loss, d_user, d_items = _port(
        lambda u, t, p: ce.full_softmax_ce(u, t * torch.from_numpy(zero0), p), user, table, pos)
    np.testing.assert_allclose(loss, float(want), rtol=1e-6)
    _close(d_user, g_u, "d_user")
    _close(d_items, g_t, "d_items")
    assert not d_items[0].any()


@pytest.mark.parametrize("chunk", [None, 8192])
def test_padded_table_matches_jax_padded_ce(chunk):
    vocab, rows = 70_000, 73_728
    user, table, pos = _case(1, vocab, rows)
    pos[5] = vocab - 1  # the last real row

    def jloss(u, t):
        return jce.fused_softmax_ce_padded(u, t, jnp.asarray(pos), vocab)

    want = jloss(jnp.asarray(user), jnp.asarray(table))
    g_u, g_t = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(user), jnp.asarray(table))
    loss, d_user, d_items = _port(ce.fused_softmax_ce_padded, user, table, pos, valid_v=vocab,
                                  chunk=chunk)
    np.testing.assert_allclose(loss, float(want), rtol=1e-6)
    _close(d_user, g_u, "d_user")
    _close(d_items, g_t, "d_items")
    assert not d_items[0].any() and not d_items[vocab:].any()  # row 0 and the pad rows
    assert d_items[pos[5]].any()


def test_captured_variant_hands_over_the_table_gradient():
    vocab, rows = 5000, 5120
    user, table, pos = _case(2, vocab, rows)
    _, d_user, d_items = _port(ce.fused_softmax_ce_padded, user, table, pos, valid_v=vocab,
                               chunk=1024)
    u = torch.from_numpy(user).requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    sink = []
    loss = ce.fused_softmax_ce_captured(u, t.detach(), torch.from_numpy(pos), sink, vocab,
                                        chunk=1024)
    assert sink == []  # filled by the backward
    loss.backward()
    assert t.grad is None and len(sink) == 1
    assert sink[0].shape == (rows, D)
    np.testing.assert_array_equal(sink[0].numpy(), d_items)
    np.testing.assert_array_equal(u.grad.numpy(), d_user)


def test_gradient_is_the_same_bits_on_every_run():
    user, table, pos = _case(3, 3000, 3000)
    pos[:8] = pos[8:]  # duplicate targets
    runs = [_port(ce.fused_softmax_ce, user, table, pos, chunk=700) for _ in range(2)]
    for a, b in zip(runs[0][1:], runs[1][1:]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="user_emb"):
        ce.fused_softmax_ce(torch.zeros(2, 3), torch.zeros(4, 5), torch.zeros(2))
