"""Each cell end to end at a tiny size on the CPU, on the port's plain
paths: the traffic generators, the checks, the metric arithmetic and the
result line's keys."""
import json
import math

import numpy as np
import pytest

from benchmark.tests.tiny import OVERRIDES, ROOT, SEED, bench, run_cell

CELLS = sorted(OVERRIDES)


def test_every_cell_has_tiny_overrides():
    assert sorted(w["name"] for w in bench()["workloads"]) == CELLS
    listed = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
    assert {w["name"] for w in listed} <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_end_to_end_line(name):
    result = run_cell(name)
    json.dumps(result)  # the line is JSON
    assert list(result)[:3] == ["correct", "attempted", "failed"]
    assert list(result)[-1] == "numbers"
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    want = [m["name"] for m in bench()["end_to_end"]
            if "workloads" not in m or name in m["workloads"]]
    assert sorted(result["metrics"]) == sorted(want)
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] >= 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for n in result["numbers"].values():
        assert n["value"] <= n["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_line(name):
    result = run_cell(name, trace=True)
    allowed = {m["name"] for m in bench()["per_layer"] if name in m["workloads"]}
    assert set(result["metrics"]) <= allowed
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["idle_gaps"]) <= 10
    if "train" in name:  # the host batch layer is timed on any device
        assert result["metrics"]["upload_ms.train"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    from benchmark.harness.cell import Cell, Run

    cell = Cell(bench(), name, OVERRIDES[name])
    pools = []
    for _ in range(2):
        run = Run(cell, SEED, "cpu", False)
        make = (cell.family.train_pool if cell.traffic["mode"] == "train"
                else cell.family.request_pool)
        pools.append(make(cell.config, cell.traffic, SEED, "cpu"))
    for a, b in zip(*pools):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
