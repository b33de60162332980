"""DeepFM served by the port against the JAX package's DeepFM.

Weights are made by the JAX package and carried across (``load_jax_variables``
or a JAX checkpoint), so both sides hold the same model.  The tolerance on
probabilities is atol 1e-5: the two frameworks sum the f32 matmuls of the
MLP in different orders.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_pangu_tpu.data import get_dataloader as jax_get_dataloader
from rec_pangu_tpu.models import get_model as jax_get_model
from rec_pangu_tpu.ops.kernels import embedding_grad as jgrad
from rec_pangu_tpu.serving import make_ranking_scorer as jax_make_ranking_scorer
from rec_pangu_tpu.train import RankTrainer as JaxRankTrainer
from rec_pangu_tpu.train.optim import make_optimizer
from rec_pangu_tpu.train.steps import create_train_state
from rec_pangu_tpu_torch.convert import jax_variables, load_jax_variables
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.serving import construct_dummy_data, make_ranking_scorer
from rec_pangu_tpu_torch.train import RankTrainer, load_checkpoint
from rec_pangu_tpu_torch.train.ckpt import ForeignObject

from conftest import RANKING_SCHEMA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS, VOCAB, DENSE, DIM, BATCH = 4, 16384, 2, 8, 2048
ATOL = 1e-5


def _enc_dict():
    enc = {}
    for f in range(FIELDS):
        enc[f"s{f}"] = {"vocab_size": VOCAB}  # ids are already encoded
    for d in range(DENSE):
        enc[f"d{d}"] = {"min": 0.0, "max": 1.0}
    return enc


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"sparse": rng.integers(0, VOCAB + 1, (BATCH, FIELDS)).astype(np.int32),
            "dense": rng.random((BATCH, DENSE)).astype(np.float32)}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_deepfm():
    model = jax_get_model("DeepFM")(enc_dict=_enc_dict(), embedding_dim=DIM,
                                    hidden_units=(16, 16))
    state = create_train_state(model, _batch(), make_optimizer(1e-3, 1),
                               jax.random.PRNGKey(0), train=False)
    return model, state


def test_scorer_matches_jax_scorer_through_k1(jax_deepfm, monkeypatch):
    monkeypatch.setenv("REC_PANGU_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("REC_PANGU_TPU_EMB_GRAD_PRECISION", "highest")
    model, state = jax_deepfm
    batch = _batch(1)
    calls = []
    select = jgrad._select_stream

    def counting(*args):
        calls.append(1)
        return select(*args)

    monkeypatch.setattr(jgrad, "_select_stream", counting)
    expected = np.asarray(jax_make_ranking_scorer(model, {"params": state.params})(batch))
    assert calls, "the JAX scorer did not reach the Pallas select kernel"

    tmodel = get_model("DeepFM")(enc_dict=_enc_dict(), embedding_dim=DIM, hidden_units=(16, 16))
    load_jax_variables(tmodel, {"params": _numpy(state.params)})
    got = make_ranking_scorer(tmodel, device="cpu")(batch)
    assert got.shape == (BATCH,) and got.dtype == np.float32
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
    # the weights round-trip back to the JAX layout unchanged
    back = jax_variables(tmodel)
    assert back["batch_stats"] is None
    jax.tree_util.tree_map(np.testing.assert_array_equal, back["params"],
                           _numpy(state.params))


def test_load_jax_variables_rejects_mismatch(jax_deepfm):
    _, state = jax_deepfm
    params = _numpy(state.params)
    tmodel = get_model("DeepFM")(enc_dict=_enc_dict(), embedding_dim=DIM, hidden_units=(16, 16))
    missing = {k: v for k, v in params.items() if k != "MLP_0"}
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables(tmodel, {"params": missing})
    extra = {**params, "Extra_0": {"w": np.zeros(1)}}
    with pytest.raises(ValueError, match="extra"):
        load_jax_variables(tmodel, {"params": extra})
    bad = {**params, "MLP_0": {**params["MLP_0"], "Dense_0": {
        "kernel": params["MLP_0"]["Dense_0"]["kernel"].T,  # [16, 34], not [34, 16]
        "bias": params["MLP_0"]["Dense_0"]["bias"]}}}
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(tmodel, {"params": bad})


def test_out_of_range_request_raises_before_upload(jax_deepfm):
    tmodel = get_model("DeepFM")(enc_dict=_enc_dict(), embedding_dim=DIM, hidden_units=(16,))
    score = make_ranking_scorer(tmodel, device="cpu")
    batch = construct_dummy_data(_enc_dict(), batch_size=3)
    assert score(batch).shape == (3,)
    batch["sparse"][1, 3] = 10 ** 6
    with pytest.raises(ValueError, match="out of range"):
        score(batch)


@pytest.fixture(scope="module")
def jax_trained(ranking_df, tmp_path_factory):
    """A JAX DeepFM trained briefly on the ranking fixture and saved with
    save_all, so the checkpoint carries an optax Adam opt_state."""
    train_df, valid_df, test_df = ranking_df[:80], ranking_df[:90], ranking_df[:95]
    loaders = jax_get_dataloader(train_df, valid_df, test_df, RANKING_SCHEMA, batch_size=32)
    enc_dict = loaders[3]
    model = jax_get_model("DeepFM")(enc_dict=enc_dict, embedding_dim=16, hidden_units=(32, 32))
    ckpt_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    trainer = JaxRankTrainer(num_task=1, model_ckpt_dir=ckpt_dir)
    trainer.fit(model, loaders[0], epoch=3, lr=1e-3)
    trainer.save_all(model, enc_dict, ckpt_dir)
    return {"model": model, "trainer": trainer, "enc_dict": enc_dict,
            "test_loader": loaders[2], "test_df": test_df,
            "path": os.path.join(ckpt_dir, "model.ckpt")}


def test_jax_checkpoint_with_optax_state_serves(jax_trained):
    j = jax_trained
    tmodel = get_model("DeepFM")(enc_dict=j["enc_dict"], embedding_dim=16,
                                 hidden_units=(32, 32))
    trainer = RankTrainer(num_task=1, device="cpu")
    ckpt = trainer.load_model(tmodel, j["path"])
    assert ckpt["enc_dict"] == j["enc_dict"]
    leaves = [x for x in jax.tree_util.tree_leaves(
        ckpt["opt_state"], is_leaf=lambda x: isinstance(x, ForeignObject))]
    assert any(isinstance(x, ForeignObject) and "optax" in x.jax_class for x in leaves)

    # predict_dataframe on rows 80..95, whose unseen values encode as OOV
    want = j["trainer"].predict_dataframe(j["model"], j["test_df"], j["enc_dict"],
                                          RANKING_SCHEMA)
    got = trainer.predict_dataframe(tmodel, j["test_df"], j["enc_dict"], RANKING_SCHEMA)
    assert got.shape == want.shape == (95,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(trainer.predict_dataloader(tmodel, j["test_loader"]),
                               want, rtol=0, atol=ATOL)
    got_m = trainer.evaluate_model(tmodel, j["test_loader"])
    want_m = j["trainer"].evaluate_model(j["model"], j["test_loader"])
    assert got_m.keys() == want_m.keys() == {"roc_auc_score", "log_loss"}
    for k in want_m:  # both are rounded to 4 dp
        assert abs(got_m[k] - want_m[k]) <= 1e-4 + 1e-12


def test_jax_checkpoint_loads_without_jax(jax_trained, tmp_path):
    """The checkpoint reader rebuilds optax's classes as placeholders, so a
    process with no jax, flax or optax can serve from it; a saved port
    checkpoint reloads to the same predictions."""
    out = tmp_path / "port_ckpt"
    j_path = jax_trained["path"]
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax"):
            sys.modules[name] = None
        import numpy as np
        from rec_pangu_tpu_torch.models import get_model
        from rec_pangu_tpu_torch.serving import construct_dummy_data, make_ranking_scorer
        from rec_pangu_tpu_torch.train import RankTrainer, load_checkpoint
        ckpt = load_checkpoint({j_path!r})
        assert ckpt["opt_state"] is not None
        model = get_model("DeepFM")(enc_dict=ckpt["enc_dict"], embedding_dim=16,
                                    hidden_units=(32, 32))
        trainer = RankTrainer(device="cpu")
        trainer.load_model(model, {j_path!r})
        trainer.save_model(model, {str(out)!r})
        batch = construct_dummy_data(ckpt["enc_dict"], batch_size=4)
        print(make_ranking_scorer(model, device="cpu")(batch).tolist())
        assert not [m for m in sys.modules if m.split(".")[0] in
                    ("rec_pangu_tpu", "jax", "flax", "optax") and sys.modules[m]]
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    preds = np.array(eval(res.stdout.strip().splitlines()[-1]))
    saved = load_checkpoint(str(out / "model.ckpt"))
    assert saved["opt_state"] is None and saved["batch_stats"] is None
    jax.tree_util.tree_map(np.testing.assert_array_equal, saved["params"],
                           _numpy(jax_trained["trainer"].state.params))
    want = np.asarray(jax_trained["model"].apply(
        {"params": saved["params"]},
        {k: jnp.asarray(v) for k, v in construct_dummy_data(
            jax_trained["enc_dict"], batch_size=4).items()}, False)["pred"]).reshape(-1)
    np.testing.assert_allclose(preds, want, rtol=0, atol=ATOL)


def test_fit_waits_for_training_slice():
    """fit and all its options are ported; a mesh argument that is not a
    mesh raises before fit touches the model."""
    with pytest.raises(TypeError, match="DeviceMesh from parallel.make_mesh"):
        RankTrainer(device="cpu").fit(None, None, profile_dir="trace", mesh=object())


@pytest.mark.parametrize("mode", ["product_sum_pooling", "Bi_interaction_pooling",
                                  "inner_product", "elementwise_product"])
def test_inner_product_matches_jax(mode):
    from rec_pangu_tpu.ops.interactions import inner_product as jax_inner_product
    from rec_pangu_tpu_torch.ops.interactions import inner_product

    emb = np.random.default_rng(3).standard_normal((64, 5, 8)).astype(np.float32)
    want = np.asarray(jax_inner_product(jnp.asarray(emb), mode))
    got = inner_product(torch.from_numpy(emb), mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_mlp_with_batchnorm_matches_jax(train):
    """BatchNorm's weights and running statistics carry across, and both
    modes agree: running averages in eval, batch statistics (and the
    momentum-0.9 update of the running ones) in train."""
    from rec_pangu_tpu.ops.mlp import MLP as JaxMLP
    from rec_pangu_tpu_torch.ops.mlp import MLP

    rng = np.random.default_rng(4)
    x = rng.standard_normal((256, 12)).astype(np.float32)
    jmlp = JaxMLP((16, 8), output_dim=1, dropout_rates=0.0, batch_norm=True)
    variables = jmlp.init(jax.random.PRNGKey(2), jnp.asarray(x), False)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.random(v.shape).astype(np.float32),
        variables["batch_stats"])  # non-trivial running statistics
    variables = {"params": variables["params"], "batch_stats": stats}
    if train:
        want, mutated = jmlp.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    else:
        want = jmlp.apply(variables, jnp.asarray(x), False)
    mlp = MLP(12, (16, 8), output_dim=1, dropout_rates=0.0, batch_norm=True)
    load_jax_variables(mlp, _numpy(variables))
    got = mlp(torch.from_numpy(x), train).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    if train:  # the running variance moves by the biased batch variance, as flax's does
        for i, bn in enumerate(mlp.bn):
            want_stats = mutated["batch_stats"][f"BatchNorm_{i}"]
            np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want_stats["mean"]),
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want_stats["var"]),
                                       rtol=0, atol=ATOL)
