"""The serving export (``export_program``) against the eager scorer and the
JAX package's exports.

DeepFM is built by the JAX package (``create_train_state``, as
``tests/test_serving.py`` builds it) and carried into the port with
``load_jax_variables``.  Its program, written by ``export_program`` on the
CPU and read back by ``torch.export.load``, is held to the port's eager
scorer within EAGER_ATOL (the same operations in the same order: measured
bit-equal) and to JAX's ``export_stablehlo`` program and jitted scorer within
JAX_ATOL, at the dummy batch's 2 rows, 5 and 80.  Every ranking model of
the port is exported at a tiny width and held to its eager scorer.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from rec_pangu_tpu.data import DataLoader, RankingDataset
from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.serving import (export_stablehlo, make_ranking_scorer as
                                   jax_ranking_scorer)
from rec_pangu_tpu.train.optim import make_optimizer
from rec_pangu_tpu.train.steps import create_train_state
from rec_pangu_tpu_torch.convert import load_jax_variables
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.ops.kernels.embedding_lookup import OP
from rec_pangu_tpu_torch.serving import (construct_dummy_data, export_program,
                                         make_ranking_scorer)

from conftest import RANKING_SCHEMA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EAGER_ATOL = 1e-6
JAX_ATOL = 1e-5
RANKING_MODELS = ["DeepFM", "WDL", "LR", "FM", "NFM", "DCN", "xDeepFM", "AutoInt", "FiBiNet",
                  "MaskNet", "AFM", "CCPM", "AOANet", "AFN"]
TABLES = {"DeepFM": 1, "WDL": 2, "LR": 1, "FM": 1, "NFM": 2, "DCN": 1, "xDeepFM": 2,
          "AutoInt": 2, "FiBiNet": 2, "MaskNet": 1, "AFM": 2, "CCPM": 1, "AOANet": 1, "AFN": 2}


@pytest.fixture(scope="module")
def trained(ranking_df):
    ds = RankingDataset(RANKING_SCHEMA, ranking_df[:80])
    batch = next(iter(DataLoader(ds, batch_size=80)))
    jmodel = jax_get_model("DeepFM")(enc_dict=ds.enc_dict, embedding_dim=8, hidden_units=(16,))
    state = create_train_state(jmodel, batch, make_optimizer(1e-3, 1), jax.random.PRNGKey(0))
    variables = {"params": state.params}
    model = get_model("DeepFM")(enc_dict=ds.enc_dict, embedding_dim=8, hidden_units=(16,))
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables))
    return jmodel, variables, model, ds.enc_dict, {k: batch[k] for k in ("sparse", "dense")}


@pytest.fixture(scope="module")
def program(trained, tmp_path_factory):
    _, _, model, enc_dict, _ = trained
    path = str(tmp_path_factory.mktemp("export") / "deepfm.pt2")
    assert export_program(model, enc_dict, path, device="cpu") == path
    return path, torch.export.load(path)


def _run(program, batch):
    out = program.module()(torch.from_numpy(np.ascontiguousarray(batch["sparse"])),
                           torch.from_numpy(np.ascontiguousarray(batch["dense"])))
    return out.detach().numpy()


def _rows(batch, n):
    return {k: v[:n] for k, v in batch.items()}


def test_program_round_trips_at_any_batch(trained, program):
    _, _, model, enc_dict, batch = trained
    _, loaded = program
    score = make_ranking_scorer(model, device="cpu")
    dummy = construct_dummy_data(enc_dict)
    got = _run(loaded, dummy)
    assert got.shape == (2,)
    np.testing.assert_allclose(got, score(dummy), rtol=0, atol=EAGER_ATOL)
    for n in (1, 5, 80):
        got = _run(loaded, _rows(batch, n))
        assert got.shape == (n,) and np.all((got >= 0) & (got <= 1))
        np.testing.assert_allclose(got, score(_rows(batch, n)), rtol=0, atol=EAGER_ATOL)


def test_program_matches_the_jax_exports(trained, program, tmp_path):
    jmodel, variables, _, enc_dict, batch = trained
    _, loaded = program
    from jax import export as jax_export

    path = export_stablehlo(jmodel, variables, enc_dict, str(tmp_path / "m.hlo"))
    with open(path, "rb") as f:
        rehydrated = jax_export.deserialize(f.read())
    two = _rows(batch, 2)
    np.testing.assert_allclose(_run(loaded, two), np.asarray(rehydrated.call(two)),
                               rtol=0, atol=JAX_ATOL)
    want = np.asarray(jax_ranking_scorer(jmodel, variables)(batch))
    np.testing.assert_allclose(_run(loaded, batch), want, rtol=0, atol=JAX_ATOL)


def test_program_keeps_one_lookup_op_a_table(trained, program):
    _, loaded = program
    calls = [n for n in loaded.graph.nodes if n.op == "call_function"]
    lookups = [n for n in calls if str(n.target).startswith(OP.replace("::", "."))]
    assert len(lookups) == 1
    # the batch dimension is dynamic on both inputs, from one row up
    (rng,) = loaded.range_constraints.values()
    assert rng.lower == 1


def test_program_reads_out_of_range_ids_as_zero_rows(trained, program):
    """The program skips the scorer's host id check: an id past its field's
    rows reads a zero row, as the lookup's plain version does."""
    _, _, model, _, batch = trained
    _, loaded = program
    bad = {k: v[:4].copy() for k, v in batch.items()}
    bad["sparse"][1, 0] = 10 ** 6
    bad["sparse"][2, 3] = -5
    with pytest.raises(ValueError, match="out of range"):
        make_ranking_scorer(model, device="cpu")(bad)
    with torch.no_grad():
        want = model({k: torch.from_numpy(v) for k, v in bad.items()},
                     train=False)["pred"].reshape(-1).numpy()
    np.testing.assert_allclose(_run(loaded, bad), want, rtol=0, atol=EAGER_ATOL)


def test_program_loads_with_the_package_alone(trained, program):
    """A fresh process that imports ``rec_pangu_tpu_torch`` (for the op) and
    nothing of JAX loads and runs the program."""
    _, _, model, _, batch = trained
    path, _ = program
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax"):
            sys.modules[name] = None
        import numpy as np, torch
        import rec_pangu_tpu_torch  # registers the lookup op
        program = torch.export.load({path!r})
        sparse = torch.from_numpy(np.load(sys.argv[1]))
        dense = torch.from_numpy(np.load(sys.argv[2]))
        print(" ".join(repr(float(v)) for v in program.module()(sparse, dense)))
    """)
    folder = os.path.dirname(path)
    args = []
    for key in ("sparse", "dense"):
        args.append(os.path.join(folder, f"{key}.npy"))
        np.save(args[-1], np.ascontiguousarray(batch[key][:6]))
    res = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    got = np.array([float(v) for v in res.stdout.split()], np.float32)
    want = make_ranking_scorer(model, device="cpu")(_rows(batch, 6))
    np.testing.assert_allclose(got, want, rtol=0, atol=EAGER_ATOL)


def _tiny_enc_dict():
    enc = {f"s{f}": {"vocab_size": 30} for f in range(4)}
    enc.update({f"d{d}": {"min": 0.0, "max": 1.0} for d in range(2)})
    return enc


@pytest.mark.parametrize("name", RANKING_MODELS)
def test_every_ranking_model_round_trips(name, tmp_path):
    enc = _tiny_enc_dict()
    model = get_model(name)(enc_dict=enc, **({} if name == "LR" else {"embedding_dim": 4}))
    loaded = torch.export.load(export_program(model, enc, str(tmp_path / f"{name}.pt2"),
                                              device="cpu"))
    lookups = [n for n in loaded.graph.nodes
               if n.op == "call_function" and str(n.target).startswith(OP.replace("::", "."))]
    assert len(lookups) == TABLES[name]
    score = make_ranking_scorer(model, device="cpu")
    rng = np.random.default_rng(0)
    for n in (3, 40):
        batch = {"sparse": rng.integers(0, 31, (n, 4)).astype(np.int32),
                 "dense": rng.random((n, 2)).astype(np.float32)}
        got = _run(loaded, batch)
        assert got.shape == (n,)
        np.testing.assert_allclose(got, score(batch), rtol=0, atol=EAGER_ATOL)
