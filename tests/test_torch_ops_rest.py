"""The layers no model of the package builds, against the JAX package's.

Dice inside an ``MLP``, ``FMLayer``, ``InteractionMachine``,
``HolographicInteraction``, ``GraphLayer``, ``FiGNNLayer`` and the masked
poolings are built by both packages at a small size (batch 16, 5 fields,
D 8).  The port loads the flax variables (``load_jax_variables``), with
Dice's ``alpha`` and every BatchNorm's statistics drawn away from their
init so that they matter, and is held to flax's outputs within ATOL (of
outputs of order 1; the interaction machine's within REL_TOL of its
largest output: its order-5 term is a sum of fifth powers) and its updated
batch statistics within ATOL.  Gradients are held in float64 on both sides
(the weights and inputs widened), within GRAD_REL_TOL of the largest
entry of any leaf's: in float32 a BatchNorm bias in front of Dice's
BatchNorm, whose output no shift moves, has a gradient that is a difference
of large terms, 2.5e-5 of its largest entry apart between the two packages,
and a bias in front of a BatchNorm has a gradient of 0 (rounding noise on
both sides).  The weights also go the other way: the port's own init,
written out by ``jax_variables``, has flax's tree and gives the port's
outputs under flax.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.ops import field_graph as jfg
from rec_pangu_tpu.ops import interactions as jint
from rec_pangu_tpu.ops import pooling as jpool
from rec_pangu_tpu.ops.mlp import MLP as JaxMLP
from rec_pangu_tpu_torch.convert import jax_variables, load_jax_variables
from rec_pangu_tpu_torch.ops import (Dice, FiGNNLayer, FMLayer, GraphLayer,
                                     HolographicInteraction, InteractionMachine, MLP,
                                     get_activation, masked_average_pooling,
                                     masked_sum_pooling)

B, F, D = 16, 5, 8
ATOL = 1e-5
REL_TOL = 1e-5
GRAD_REL_TOL = 1e-9


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _perturbed(variables, seed):
    """The flax variables with every leaf that inits to a constant (Dice's
    alpha, biases, BatchNorm statistics) drawn away from it: a positive
    variance, random means and terms."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        leaf = np.asarray(leaf)
        if leaf.ndim > 1 and np.std(leaf) > 0:
            return leaf
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, _np(variables))


def _assert_tree(got, want, atol, what):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys(), what
    for key, arr in got.items():
        np.testing.assert_allclose(arr, want[key], rtol=0, atol=atol, err_msg=f"{what} {key}")


def _assert_grads64(j, t, variables, args, cot, kw, mutable):
    """flax's and the port's gradients of sum(out * cot) by the params, both
    in float64, within GRAD_REL_TOL of the largest entry of any leaf's."""
    wide = lambda a: np.asarray(a, np.float64)  # noqa: E731
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        v64 = jax.tree_util.tree_map(wide, variables)

        def loss(params):
            out = j.apply({**v64, "params": params}, *map(wide, args), **kw, mutable=mutable)
            out = out[0] if mutable else out
            return jnp.sum(out * wide(cot))

        grads = _np(jax.grad(loss)(v64["params"]))
    t64 = copy.deepcopy(t).double()
    out = t64(*(torch.from_numpy(wide(a)) for a in args), **kw)
    (out * torch.from_numpy(wide(cot))).sum().backward()
    got = {"/".join(p): (w.grad.numpy().T if tr else w.grad.numpy())
           for c, p, w, tr in t64.jax_leaves() if c == "params"}
    want = {"/".join(k.strip("[]'") for k in key.split("][")): arr
            for key, arr in _leaves(grads).items()}
    assert got.keys() == want.keys()
    scale = max(np.abs(arr).max() for arr in want.values())
    for path, arr in want.items():
        err = np.abs(got[path] - arr).max() / scale
        assert err <= GRAD_REL_TOL, (path, err)
    return got


def _assert_rel(got, want, rel_tol, what):
    err = np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()
    assert err <= rel_tol, (what, err)


# --------------------------------------------------------------------------- #
# Dice in an MLP
# --------------------------------------------------------------------------- #
DICE_ACTS = [["dice", "dice"], ["dice", "relu", "dice"]]


def _mlp_pair(acts, batch_norm):
    units = (12, 10, 6)[:len(acts)]
    j = JaxMLP(hidden_units=units, output_dim=1, hidden_activations=acts,
               dropout_rates=0.0, batch_norm=batch_norm)
    t = MLP(F * D, units, output_dim=1, hidden_activations=acts, dropout_rates=0.0,
            batch_norm=batch_norm)
    return j, t


@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("acts", DICE_ACTS, ids=["-".join(a) for a in DICE_ACTS])
def test_dice_mlp_matches_flax(acts, batch_norm):
    j, t = _mlp_pair(acts, batch_norm)
    x = _x(B, F * D, seed=1)
    variables = _perturbed(j.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 2)
    load_jax_variables(t, variables)
    assert len(t.dice) == acts.count("dice")

    want_eval = np.asarray(j.apply(variables, jnp.asarray(x), train=False))
    got_eval = t(torch.from_numpy(x), train=False).detach().numpy()
    np.testing.assert_allclose(got_eval, want_eval, rtol=0, atol=ATOL)

    cot = _x(B, 1, seed=3)
    got_grads = _assert_grads64(j, t, variables, (x,), cot, {"train": True}, ["batch_stats"])
    want_train, new_stats = j.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
    got_train = t(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got_train.detach().numpy(), np.asarray(want_train),
                               rtol=0, atol=ATOL)
    _assert_tree(jax_variables(t)["batch_stats"], new_stats["batch_stats"], ATOL,
                 "batch_stats")
    assert any(p.startswith("Dice_") and p.endswith("alpha") for p in got_grads)


def test_get_activation_refuses_dice():
    with pytest.raises(ValueError, match="instantiate ops.Dice directly"):
        get_activation("dice")
    with pytest.raises(ValueError, match="instantiate ops.Dice directly"):
        get_activation("Dice")


def test_dice_alone_is_the_formula():
    """At alpha = 1 Dice is the identity; at alpha = 0, in eval with the
    init's statistics (mean 0, variance 1), x * sigmoid(x / sqrt(1 + eps))."""
    dice = Dice(D)
    x = torch.from_numpy(_x(B, D, seed=4))
    with torch.no_grad():
        dice.alpha.fill_(1.0)
    np.testing.assert_allclose(dice(x).detach().numpy(), x.numpy(), rtol=0, atol=1e-6)
    with torch.no_grad():
        dice.alpha.zero_()
    want = x * torch.sigmoid(x / torch.sqrt(torch.tensor(1.0 + Dice.EPS)))
    np.testing.assert_allclose(dice(x).detach().numpy(), want.numpy(), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------- #
# interactions
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("final_activation", ["", "sigmoid"])
def test_fm_layer_matches_flax(final_activation):
    emb = _x(B, F, D, seed=5)
    want = jint.FMLayer(final_activation).apply({}, jnp.asarray(emb))
    got = FMLayer(final_activation)(torch.from_numpy(emb))
    assert got.shape == (B, 1) and FMLayer().jax_leaves() == []
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_interaction_machine_matches_flax(order, batch_norm):
    emb = _x(B, F, D, seed=6, scale=0.5)
    j = jint.InteractionMachine(order=order, batch_norm=batch_norm)
    variables = _perturbed(j.init(jax.random.PRNGKey(1), jnp.asarray(emb), train=False), 7)
    t = InteractionMachine(D, order=order, batch_norm=batch_norm)
    load_jax_variables(t, variables)
    want = np.asarray(j.apply(variables, jnp.asarray(emb), train=False))
    _assert_rel(t(torch.from_numpy(emb), train=False).detach().numpy(), want, REL_TOL, "eval")
    want_train, stats = j.apply(variables, jnp.asarray(emb), train=True,
                                mutable=["batch_stats"])
    got_train = t(torch.from_numpy(emb), train=True).detach().numpy()
    _assert_rel(got_train, np.asarray(want_train), REL_TOL, "train")
    if batch_norm:
        got_stats, want_stats = (_leaves(jax_variables(t)["batch_stats"]),
                                 _leaves(stats["batch_stats"]))
        assert got_stats.keys() == want_stats.keys()
        for key, arr in got_stats.items():
            _assert_rel(arr, want_stats[key], REL_TOL, key)


HOLO_TYPES = ["hadamard_product", "circular_convolution", "circular_correlation"]


@pytest.mark.parametrize("kind", HOLO_TYPES)
def test_holographic_interaction_matches_flax(kind):
    emb = _x(B, F, D, seed=8)
    want = jint.HolographicInteraction(kind).apply({}, jnp.asarray(emb))
    got = HolographicInteraction(kind)(torch.from_numpy(emb))
    assert got.shape == (B, F * (F - 1) // 2, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="not supported"):
        HolographicInteraction("circular")


# --------------------------------------------------------------------------- #
# field graph
# --------------------------------------------------------------------------- #
def test_graph_layer_matches_flax():
    h = _x(B, F, D, seed=9)
    g = np.array(jax.nn.softmax(jnp.asarray(_x(B, F, F, seed=10)), axis=-1))
    j = jfg.GraphLayer(F, D)
    variables = _perturbed(j.init(jax.random.PRNGKey(2), jnp.asarray(g), jnp.asarray(h)), 11)
    t = GraphLayer(F, D)
    load_jax_variables(t, variables)
    want = j.apply(variables, jnp.asarray(g), jnp.asarray(h))
    got = t(torch.from_numpy(g), torch.from_numpy(h))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


FIGNN = [  # (use_gru, use_residual, reuse_graph_layer)
    (True, True, False), (True, True, True), (True, False, False),
    (False, True, False), (False, False, True)]


@pytest.mark.parametrize("use_gru,use_residual,reuse", FIGNN,
                         ids=[f"gru{int(a)}-res{int(b)}-reuse{int(c)}" for a, b, c in FIGNN])
def test_fignn_layer_matches_flax(use_gru, use_residual, reuse):
    emb = _x(B, F, D, seed=12, scale=0.5)
    kw = dict(gnn_layers=3, reuse_graph_layer=reuse, use_gru=use_gru,
              use_residual=use_residual)
    j = jfg.FiGNNLayer(F, D, **kw)
    variables = _perturbed(j.init(jax.random.PRNGKey(3), jnp.asarray(emb)), 13)
    t = FiGNNLayer(F, D, **kw)
    load_jax_variables(t, variables)
    want = j.apply(variables, jnp.asarray(emb))
    got = t(torch.from_numpy(emb))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    _assert_grads64(j, t, variables, (emb,), _x(B, F, D, seed=14), {}, False)
    g = t.adjacency(torch.from_numpy(emb))
    assert torch.all(torch.diagonal(g, dim1=1, dim2=2) == 0)
    np.testing.assert_allclose(g.sum(-1).detach().numpy(), 1.0, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------- #
# poolings
# --------------------------------------------------------------------------- #
def test_masked_poolings_match_flax():
    x = _x(B, 7, D, seed=15)
    lengths = np.random.default_rng(16).integers(0, 8, B)
    x[np.arange(7)[None, :] >= lengths[:, None]] = 0.0  # padded positions, an empty row too
    x[0, 0, :3] = 0.0                                    # zeros inside a real row
    lengths[1] = 0
    x[1] = 0.0
    for ours, theirs in ((masked_average_pooling, jpool.masked_average_pooling),
                         (masked_sum_pooling, jpool.masked_sum_pooling)):
        got = ours(torch.from_numpy(x)).numpy()
        want = np.asarray(theirs(jnp.asarray(x)))
        assert got.shape == (B, D)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=ours.__name__)
    np.testing.assert_array_equal(masked_average_pooling(torch.from_numpy(x))[1].numpy(), 0.0)


# --------------------------------------------------------------------------- #
# the weight carry, the other way
# --------------------------------------------------------------------------- #
def _carry_cases():
    emb = _x(B, F, D, seed=17, scale=0.5)
    g = np.array(jax.nn.softmax(jnp.asarray(_x(B, F, F, seed=18)), axis=-1))
    flat = _x(B, F * D, seed=19)
    j_mlp, t_mlp = _mlp_pair(["dice", "relu", "dice"], True)
    return {
        "MLP-dice": (j_mlp, t_mlp, (flat,), {"train": False}),
        "InteractionMachine": (jint.InteractionMachine(order=5, batch_norm=True),
                               InteractionMachine(D, order=5, batch_norm=True), (emb,),
                               {"train": False}),
        "GraphLayer": (jfg.GraphLayer(F, D), GraphLayer(F, D), (g, emb), {}),
        "FiGNNLayer": (jfg.FiGNNLayer(F, D), FiGNNLayer(F, D), (emb,), {}),
        "FiGNNLayer-reuse": (jfg.FiGNNLayer(F, D, reuse_graph_layer=True),
                             FiGNNLayer(F, D, reuse_graph_layer=True), (emb,), {}),
    }


CARRY = sorted(_carry_cases())


@pytest.mark.parametrize("name", CARRY)
def test_port_weights_run_under_flax(name):
    j, t, args, kw = _carry_cases()[name]
    init = _np(j.init(jax.random.PRNGKey(4), *map(jnp.asarray, args), **kw))
    variables = jax_variables(t)
    ours = {k: v for k, v in variables.items() if v is not None}
    got_shapes = jax.tree_util.tree_map(np.shape, ours)
    assert got_shapes == jax.tree_util.tree_map(np.shape, init), name
    want = t(*map(torch.from_numpy, args), **kw).detach().numpy()
    got = np.asarray(j.apply(jax.tree_util.tree_map(jnp.asarray, ours),
                             *map(jnp.asarray, args), **kw))
    _assert_rel(got, want, REL_TOL, name)
    # and back: the written tree loads into a fresh module, bit for bit
    fresh = _carry_cases()[name][1]
    load_jax_variables(fresh, ours)
    _assert_tree(jax_variables(fresh)["params"], variables["params"], 0.0, name)
