"""On the card: each cell's control (the plain reference in the program's
place, in TF32, the precision below the configurations' float32) fails at
least one of the cell's limits, on three seeds, at the cell's own size.
Run with ``python -m pytest benchmark/tests -m card`` on a machine with a
CUDA card; without one these tests skip."""
import json

import pytest
import torch

from benchmark.tests.tiny import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.harness.cell import Cell, Run, precision

    cell = Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), name)
    for seed in SEEDS:
        with precision(cell.config["allow_tf32"]):
            numbers = cell.mode.control(Run(cell, seed, "cuda", False))
        assert any(v > cell.limits[k] for k, v in numbers.items()), (seed, numbers)
        torch.cuda.empty_cache()
