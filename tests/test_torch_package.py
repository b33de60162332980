"""Boundaries of the port: it imports nothing of JAX or of the JAX package,
imports without pandas, builds nothing at import, and runs on the CPU only
when asked to."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "rec_pangu_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "rec_pangu_tpu"}


def test_imports_without_jax_flax_optax_or_pandas():
    code = textwrap.dedent("""
        import subprocess, sys
        for name in ("jax", "jaxlib", "flax", "optax", "pandas"):
            sys.modules[name] = None

        def no_process(*args, **kwargs):
            raise AssertionError("importing the package must start no process")

        subprocess.Popen = no_process
        import rec_pangu_tpu_torch
        import rec_pangu_tpu_torch.serving, rec_pangu_tpu_torch.models
        import rec_pangu_tpu_torch.train, rec_pangu_tpu_torch.convert
        import rec_pangu_tpu_torch.ops.kernels.embedding_lookup
        import rec_pangu_tpu_torch.ops.kernels.fused_adam
        import rec_pangu_tpu_torch.train.fused_update
        import rec_pangu_tpu_torch.ops.kernels.fused_encoder
        import rec_pangu_tpu_torch.ops.kernels.global_attn
        import rec_pangu_tpu_torch.ops.kernels.multimax_ce
        import rec_pangu_tpu_torch.ops.sequence_enc, rec_pangu_tpu_torch.eval.retrieval
        import rec_pangu_tpu_torch.data.sequence, rec_pangu_tpu_torch.models.sequence
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in {"rec_pangu_tpu", "jax", "flax", "optax"})
        assert not loaded, loaded
        assert "DeepFM" in rec_pangu_tpu_torch.models.MODEL_REGISTRY
        assert "SASRec" in rec_pangu_tpu_torch.models.MODEL_REGISTRY
        assert "IOCRec" in rec_pangu_tpu_torch.models.MODEL_REGISTRY
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_sources_import_nothing_of_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for root, line in _imported_roots(f)
           if root in FORBIDDEN_ROOTS]
    assert not bad, bad
    for f in files:  # nor dynamically
        text = f.read_text()
        assert "import_module(\"jax" not in text and "rec_pangu_tpu." not in text.replace(
            "rec_pangu_tpu_torch.", ""), f


def test_entry_points_require_cuda_by_default(monkeypatch):
    from rec_pangu_tpu_torch.models import get_model
    from rec_pangu_tpu_torch.serving import make_ranking_scorer, make_retrieval_scorer
    from rec_pangu_tpu_torch.train import RankTrainer, SequenceTrainer
    from rec_pangu_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = {"a": {"vocab_size": 3}, "b": {"min": 0.0, "max": 1.0}}
    model = get_model("DeepFM")(enc_dict=enc, embedding_dim=4, hidden_units=(4,))
    sasrec = get_model("SASRec")(enc_dict={"item_id": {"vocab_size": 9}},
                                 config={"embedding_dim": 4, "max_length": 5, "n_heads": 2})
    for call in (lambda: resolve_device(None), lambda: resolve_device("cuda:0"),
                 lambda: RankTrainer(), lambda: make_ranking_scorer(model),
                 lambda: SequenceTrainer(), lambda: make_retrieval_scorer(sasrec)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert RankTrainer(device="cpu").device == torch.device("cpu")
    assert SequenceTrainer(device="cpu").device == torch.device("cpu")


def test_out_of_range_item_id_raises_before_upload():
    from rec_pangu_tpu_torch.models import get_model
    from rec_pangu_tpu_torch.serving import make_retrieval_scorer

    model = get_model("SASRec")(enc_dict={"item_id": {"vocab_size": 9}},
                                config={"embedding_dim": 4, "max_length": 5, "n_heads": 2})
    retrieve = make_retrieval_scorer(model, topk=3, device="cpu")
    batch = {"hist_item_list": np.array([[1, 8, 0, 0, 0], [2, 3, 4, 0, 0]], np.int32),
             "hist_mask_list": np.array([[1, 1, 0, 0, 0], [1, 1, 1, 0, 0]], np.float32)}
    scores, ids = retrieve(batch)
    assert scores.shape == ids.shape == (2, 3)
    for bad in (9, -1):  # the vocabulary is 0..8 (0 = padding)
        batch["hist_item_list"][1, 2] = bad
        with pytest.raises(ValueError, match="out of range"):
            retrieve(batch)


def test_chip_smoke_fails_without_cuda():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
