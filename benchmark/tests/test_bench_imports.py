"""What a run may load: no module whose top-level name is jax, jaxlib, flax,
optax or rec_pangu_tpu (whole names: rec_pangu_tpu_torch is the program);
the references import nothing of the program; without a card, or without
the program beside it, the harness prints no result."""
import ast
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

from benchmark.tests.tiny import ROOT

BENCH = ROOT / "benchmark"


def _python(code: str, cwd: Path = ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_forbidden_names_are_whole_names(monkeypatch):
    from benchmark.harness.cell import forbidden_modules

    base = set(forbidden_modules())
    monkeypatch.setitem(sys.modules, "rec_pangu_tpu_torch_extra", None)
    assert set(forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "rec_pangu_tpu.models", None)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", None)
    assert {"rec_pangu_tpu", "jaxlib"} <= set(forbidden_modules())


def test_a_run_loads_no_forbidden_module():
    out = _python("""
        import sys
        sys.path.insert(0, ".")
        from benchmark.tests.tiny import OVERRIDES, run_cell
        from benchmark.harness.cell import forbidden_modules
        for name in OVERRIDES:
            assert run_cell(name, trace=True)["correct"]
        print("FOUND", forbidden_modules())
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_references_import_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("rec_pangu_tpu_torch", "rec_pangu_tpu", "jax",
                                                  "benchmark"), (path.name, name)
    out = _python("""
        import sys
        sys.path.insert(0, ".")
        import benchmark.reference.common, benchmark.reference.sasrec
        print("LOADED", sorted(m for m in sys.modules if m.split(".")[0].startswith("rec_pangu")))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_no_result_without_a_card_or_the_program(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's files alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".work"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sasrec_1m.train",
                          "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
