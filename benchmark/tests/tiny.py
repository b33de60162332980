"""Tiny overrides of each cell, for runs on the CPU: the cells' shapes are
kept, their sizes cut."""
import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OVERRIDES = {
    "sasrec_1m.train": {"config": {"vocab_size": 3000}, "traffic": {"batch": 32, "pool": 8}},
    "sasrec_1m.retrieve": {"config": {"vocab_size": 3000},
                           "traffic": {"batch": 16, "pool": 8, "keep_every": 1, "topk": 20,
                                       "check_requests": 3}},
}
SEED = 2 ** 31 + 17  # more than 32 signed bits hold


def bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def run_cell(name: str, trace: bool = False, seconds: float = 0.3, seed: int = SEED,
             overrides=None) -> dict:
    from benchmark.harness.cell import Cell, execute

    cell = Cell(bench(), name, overrides or OVERRIDES[name])
    return execute(cell, seed, seconds, trace, "cpu", time.perf_counter())
