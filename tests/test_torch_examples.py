"""The port's example scripts (``examples/**/*_torch.py``).

The ranking, inference and multi-task examples run on the CPU as
subprocesses on the bundled 100-row CSVs, in a temporary working directory
(they write ``./model_ckpt`` there; the inference example reads the ranking
example's checkpoint and exports it), and must exit 0 and print their
predictions.  Every example byte-compiles.
"""
import os
import py_compile
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = sorted(REPO.glob("examples/**/*_torch.py"))
TIMEOUT_S = 180


def _run(script: str, cwd) -> str:
    res = subprocess.run([sys.executable, str(REPO / "examples" / script), "--device", "cpu"],
                         cwd=cwd, capture_output=True, text=True, timeout=TIMEOUT_S,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


def test_ten_examples_are_ported():
    originals = sorted(p for p in REPO.glob("examples/**/*.py") if not p.stem.endswith("_torch"))
    assert len(EXAMPLES) == len(originals) == 10
    assert {p.with_name(p.stem + "_torch.py") for p in originals} == set(EXAMPLES)


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.stem for p in EXAMPLES])
def test_example_compiles(path, tmp_path):
    py_compile.compile(str(path), cfile=str(tmp_path / "example.pyc"), doraise=True)


def test_ranking_then_inference_examples_run_on_the_cpu(tmp_path):
    out = _run("ranking/run_ranking_example_torch.py", tmp_path)
    assert "Test metric:" in out and "predict_dataframe:" in out and "(95,)" in out
    assert (tmp_path / "model_ckpt" / "model.ckpt").exists()
    out = _run("ranking/inference_example_torch.py", tmp_path)
    assert "Predictions:" in out and "Exported program predictions:" in out
    assert (tmp_path / "model_ckpt" / "deepfm.pt2").exists()
    diff = float(re.search(r"max abs difference: (\S+)", out).group(1))
    assert diff <= 1e-6


def test_multi_task_example_runs_on_the_cpu(tmp_path):
    out = _run("multi_task/run_multi_task_example_torch.py", tmp_path)
    assert "Test metric:" in out and "predict_dataframe:" in out and "(95, 2)" in out
