"""The ranking zoo of the port against the JAX package's models, in eval.

Each of the 13 models the port adds beside DeepFM is built by both packages
at a small size (4 fields of 50 ids, 2 dense features, D=8); the port loads
the JAX model's variables (``load_jax_variables``, BatchNorm statistics
moved away from their init) and its eval predictions agree within 1e-5, and
``jax_variables`` gives the JAX variables back unchanged.  The train step is
held in ``test_torch_ranking_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu_torch.convert import jax_variables, load_jax_variables
from rec_pangu_tpu_torch.models import get_model

NEW_MODELS = ["WDL", "LR", "FM", "NFM", "DCN", "xDeepFM", "AutoInt", "FiBiNet", "MaskNet",
              "AFM", "CCPM", "AOANet", "AFN"]
FIELDS, VOCAB, DENSE, DIM, BATCH = 4, 50, 2, 8, 64
ATOL = 1e-5


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


def _kwargs(name):
    return {} if name == "LR" else {"embedding_dim": DIM}


@pytest.mark.parametrize("name", NEW_MODELS)
def test_model_matches_jax_in_eval(name):
    batch = _batch(0)
    jmodel = jax_get_model(name)(enc_dict=_enc_dict(), **_kwargs(name))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _numpy(dict(jmodel.init({"params": jax.random.PRNGKey(1),
                                         "dropout": jax.random.PRNGKey(2)}, jbatch, False)))
    if "batch_stats" in variables:  # running statistics away from their init
        rng = np.random.default_rng(3)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda v: v + rng.random(v.shape).astype(np.float32), variables["batch_stats"])
    want = np.asarray(jmodel.apply(variables, jbatch, False)["pred"])
    model = get_model(name)(enc_dict=_enc_dict(), **_kwargs(name))
    load_jax_variables(model, variables)
    got = model.eval()({k: torch.from_numpy(v) for k, v in batch.items()})["pred"]
    assert got.shape == (BATCH, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)
    # and back: the port's variables are the JAX model's
    back = jax_variables(model)
    for coll in ("params", "batch_stats"):
        want_leaves = jax.tree_util.tree_leaves_with_path(variables.get(coll))
        got_leaves = dict(jax.tree_util.tree_leaves_with_path(back[coll]))
        assert len(got_leaves) == len(want_leaves)
        for path, arr in want_leaves:
            np.testing.assert_array_equal(got_leaves[path], arr)


