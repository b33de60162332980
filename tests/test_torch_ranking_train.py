"""The ranking zoo's train steps against the JAX package's.

The fused train step (several tables: WDL's LR table beside its embedding,
AFN's two) is held against the JAX fused step in interpret mode (K1, K3 at
``highest`` precision) at the DeepFM training test's size, with the MLPs'
dropout off on both sides (the JAX package's masks cannot be drawn here):
after one step the parameters agree within 1e-6 and three losses within rtol
1e-4, as DeepFM's do.  AFN (a log, an exp and two BatchNorms) is held by its
first-step gradients against ``jax.grad`` within 5e-5 of each leaf's largest
entry (measured 1.84e-5) and its parameters after one step within 1e-6 on
all but AFN_HANDFUL elements (measured: 326 of 1,180,000), those within
2 lr: Adam's first step is lr * sign(g) wherever |g| >> eps, and where a
gradient lies within the float32 rounding of a sum of large terms its sign
is the rounding's.  Its BatchNorm statistics after one step agree within
rtol 1e-4 (the exp's variance, near 1.1e4, within 2.8e-5).
"""
import functools

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.ops.embedding import attach_emb_plan
from rec_pangu_tpu.train import optim as jax_optim
from rec_pangu_tpu.train.fused_update import maybe_enable_fused_update as jax_enable_fused
from rec_pangu_tpu.train.steps import create_train_state
from rec_pangu_tpu_torch.convert import jax_variables, load_jax_variables
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.ops.mlp import MLP
from rec_pangu_tpu_torch.train.fused_update import FusedStep, maybe_enable_fused_update
from rec_pangu_tpu_torch.train.steps import StandardStep

FIELDS, VOCAB, DENSE, DIM, BATCH = 4, 50, 2, 8, 64
# the fused-step tests: the JAX fused step engages on tables of 64k rows up
STEP_VOCAB, STEP_BATCH = 16384, 2048
LR = 1e-3
STEP_CONFIGS = {"WDL": {"embedding_dim": DIM, "hidden_units": (16, 16)},
                "AFN": {"embedding_dim": DIM, "dnn_hidden_units": (16, 16),
                        "afn_hidden_units": (16, 16)}}
TABLE_PATHS = {"WDL": ["LRLayer_0/FusedEmbedding_0/table", "FusedEmbedding_0/table"],
               "AFN": ["FusedEmbedding_0/table", "embedding2/table"]}
AFN_GRAD_REL_TOL = 5e-5
AFN_HANDFUL = 512
BN_RTOL = 1e-4


def _enc_dict(vocab=VOCAB):
    enc = {f"s{f}": {"vocab_size": vocab} for f in range(FIELDS)}
    enc.update({f"d{d}": {"min": 0.0, "max": 1.0} for d in range(DENSE)})
    return enc


def _batch(seed, vocab=VOCAB, rows=BATCH):
    rng = np.random.default_rng(seed)
    return {"sparse": rng.integers(0, vocab + 1, (rows, FIELDS)).astype(np.int32),
            "dense": rng.random((rows, DENSE)).astype(np.float32),
            "label": rng.integers(0, 2, rows).astype(np.float32)}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _NoDropout(fnn.Module):
    """flax ``Dropout`` as the identity: the JAX side of the fused-step
    comparison, whose masks the port cannot draw."""

    rate: float = 0.0
    deterministic: bool = True

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, MLP):
            m.drops = [0.0] * len(m.drops)
    return model


@functools.lru_cache(maxsize=None)
def jax_fused_run(name):
    """Three JAX fused steps (K1 and K3 in interpret mode) from one seeded
    model: its variables before, after step 1, the three losses, and the
    first step's gradients by ``jax.grad``."""
    enc = _enc_dict(STEP_VOCAB)
    batches = [_batch(s, STEP_VOCAB, STEP_BATCH) for s in (10, 11, 12)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
        mp.setenv("REC_PANGU_TPU_EMB_GRAD_PRECISION", "highest")
        mp.setattr(fnn, "Dropout", _NoDropout)
        model = jax_get_model(name)(enc_dict=enc, **STEP_CONFIGS[name])
        state = create_train_state(model, batches[0], jax_optim.make_optimizer(LR, 1),
                                   jax.random.PRNGKey(0))
        planned = [attach_emb_plan(dict(b), model.spec, DIM) for b in batches]
        state, step, tables = jax_enable_fused(state, model, planned[0], LR, 1)
        assert step is not None, "the JAX fused step did not engage"
        start = {"params": _numpy(state.params),
                 "batch_stats": None if state.batch_stats is None else _numpy(state.batch_stats)}
        jbatch = {k: jnp.asarray(v) for k, v in batches[0].items()}

        def loss(params):
            variables = {k: v for k, v in start.items() if v is not None}
            out, _ = model.apply({**variables, "params": params}, jbatch, True,
                                 mutable=["batch_stats"])
            return out["loss"]

        grads = _numpy(jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, start["params"])))
        losses, after_one = [], None
        for b in planned:
            state, out = step(state, b, jax.random.PRNGKey(1))
            losses.append(float(out["loss"]))
            after_one = after_one or {
                "params": _numpy(state.params),
                "batch_stats": None if state.batch_stats is None else _numpy(state.batch_stats)}
    return {"name": name, "enc": enc, "start": start, "after_one": after_one, "grads": grads,
            "losses": losses, "batches": batches,
            "tables": sorted("/".join(p) for p in tables)}


def _port_model(run):
    model = get_model(run["name"])(enc_dict=run["enc"], **STEP_CONFIGS[run["name"]])
    load_jax_variables(model, run["start"])
    return _no_dropout(model).train()


def _run(model, step, batches):
    losses, after_one = [], None
    for i, batch in enumerate(batches):
        out = step(model.upload_batch(batch, torch.device("cpu"), train=True), i)
        losses.append(float(out["loss"].detach()))
        after_one = after_one or jax_variables(model)
    return losses, after_one


def _leaves(tree):
    return {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", ["WDL", "AFN"])
def test_fused_step_matches_jax_fused_step(name):
    j = jax_fused_run(name)
    model = _port_model(j)
    step = maybe_enable_fused_update(model, LR, 1)
    assert isinstance(step, FusedStep) and len(step.tables) == 2
    losses, after_one = _run(model, step, j["batches"])
    np.testing.assert_allclose(losses, j["losses"], rtol=1e-4)
    got, want = _leaves(after_one["params"]), _leaves(j["after_one"]["params"])
    assert got.keys() == want.keys()
    beyond = 0
    for key, arr in got.items():
        diff = np.abs(arr - want[key])
        if name == "AFN":
            assert diff.max() <= 2 * LR + 1e-6, key
            beyond += int((diff > 1e-6).sum())
        else:
            np.testing.assert_allclose(arr, want[key], rtol=0, atol=1e-6, err_msg=key)
    assert beyond <= AFN_HANDFUL
    if name == "AFN":
        want_bs = _leaves(j["after_one"]["batch_stats"])
        for key, arr in _leaves(after_one["batch_stats"]).items():
            np.testing.assert_allclose(arr, want_bs[key], rtol=BN_RTOL, atol=1e-6, err_msg=key)
    # one moment pair per table, under the JAX step's table paths
    tables = step.opt_state(3)["tables"]
    assert sorted(tables) == j["tables"] == sorted(TABLE_PATHS[name])
    for (_, emb), path in zip(step.tables, TABLE_PATHS[name]):
        assert tables[path]["mu"].shape == tables[path]["nu"].shape == tuple(emb.table.shape)


def test_afn_first_step_gradients_match_jax():
    j = jax_fused_run("AFN")
    model = _port_model(j)
    out = model(model.upload_batch(j["batches"][0], torch.device("cpu"), train=True), True)
    out["loss"].backward()
    grads = {"/".join(p): (t.grad.numpy().T if tr else t.grad.numpy())
             for c, p, t, tr in model.jax_leaves() if c == "params"}
    for path, want in jax.tree_util.tree_leaves_with_path(j["grads"]):
        key = "/".join(k.key for k in path)
        if key == "log_bn/bias":  # 0 analytically: exp_bn undoes any shift it makes
            np.testing.assert_allclose(grads[key], want, rtol=0, atol=1e-6)
            continue
        err = np.abs(grads[key] - want).max() / np.abs(want).max()
        assert err <= AFN_GRAD_REL_TOL, (key, err)


def test_wdl_standard_step_matches_fused_step(monkeypatch):
    """Autograd's table gradients (one per table: the lookup's backward)
    and torch's Adam give the fused step's parameters."""
    j = jax_fused_run("WDL")
    fused_model, std_model = _port_model(j), _port_model(j)
    _, fused = _run(fused_model, maybe_enable_fused_update(fused_model, LR, 1),
                    j["batches"][:1])
    monkeypatch.setenv("REC_PANGU_TPU_FUSED_ADAM", "0")
    assert maybe_enable_fused_update(std_model, LR, 1) is None
    _, std = _run(std_model, StandardStep(std_model, LR, 1), j["batches"][:1])
    got, want = _leaves(std["params"]), _leaves(fused["params"])
    for key, arr in got.items():
        np.testing.assert_allclose(arr, want[key], rtol=0, atol=1e-6, err_msg=key)


def test_wdl_fused_step_sorts_once_a_step(monkeypatch):
    """WDL's two tables share their height, so the fused step makes the ids
    ready once a step (``fused_adam.sort_for``) and updates both tables on
    them: the same bits, after three steps, as one ``planned_adam_update``
    a table (the JAX comparison above runs on the shared sort too)."""
    from rec_pangu_tpu_torch.train import fused_update

    j = jax_fused_run("WDL")
    sorts = []
    sort_for = fused_update.sort_for
    monkeypatch.setattr(fused_update, "sort_for",
                        lambda ids, num_rows: sorts.append(num_rows) or sort_for(ids, num_rows))
    shared = _port_model(j)
    step = maybe_enable_fused_update(shared, LR, 1)
    _run(shared, step, j["batches"])
    heights = [emb.table.shape[0] for _, emb in step.tables]
    assert len(heights) == 2 and heights[0] == heights[1]
    assert sorts == heights[:1] * len(j["batches"])

    monkeypatch.setattr(fused_update, "update_sorted",
                        lambda plan, *args: fused_update.planned_adam_update(plan.ids, *args))
    separate = _port_model(j)
    _run(separate, maybe_enable_fused_update(separate, LR, 1), j["batches"])
    got, want = _leaves(jax_variables(shared)["params"]), _leaves(jax_variables(separate)["params"])
    assert got.keys() == want.keys()
    for key, arr in got.items():
        np.testing.assert_array_equal(arr, want[key], err_msg=key)
