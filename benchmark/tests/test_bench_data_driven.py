"""A new cell and a new per-layer metric, written as files only, run
without an edit to any file that is there."""
import hashlib
import json
import shutil
import subprocess
import sys
import textwrap

from benchmark.tests.tiny import ROOT


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_as_data(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".work"))
    before = _digests(tmp_path / "benchmark")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sasrec_1m.retrieve_u64", "config": "sasrec_1m",
                               "traffic": "retrieve_b64_top50", "chips": 1,
                               "why": "small requests"})
    for m in bench["end_to_end"]:
        if "serve_rows_per_s" == m["name"] or "serve_p95_ms" == m["name"]:
            m["workloads"].append("sasrec_1m.retrieve_u64")
    bench["per_layer"].append({"name": "requests.serve", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "whole request",
                               "moves": "serve_rows_per_s",
                               "workloads": ["sasrec_1m.retrieve_u64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "benchmark/traffic/retrieve_b1024_top200.json").read_text())
    traffic.update(batch=64, topk=50)
    (tmp_path / "benchmark/traffic/retrieve_b64_top50.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "benchmark/limits/sasrec_1m.retrieve.json",
                tmp_path / "benchmark/limits/sasrec_1m.retrieve_u64.json")
    (tmp_path / "benchmark/metrics/requests.serve.py").write_text(
        "def read(run):\n    return run.stats['count']\n")
    code = f"""
        import json, sys, time
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]
        from benchmark.harness.cell import Cell, execute
        bench = json.load(open({str(tmp_path / 'BENCHMARK.json')!r}))
        over = {{"config": {{"vocab_size": 3000}},
                 "traffic": {{"batch": 16, "keep_every": 1, "check_requests": 2}}}}
        cell = Cell(bench, "sasrec_1m.retrieve_u64", over)
        assert cell.family.__file__.startswith({str(tmp_path)!r})
        print(json.dumps(execute(cell, 5, 0.3, True, "cpu", time.perf_counter())))
    """
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["requests.serve"]["value"] == result["attempted"]
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
