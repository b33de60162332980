"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``rec_pangu_tpu_torch``.  With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiler trace of the
window.  The last lines of standard error name each number the correctness
check compared beside its limit; the last line of standard output is the
result, a JSON object.  A run exits non-zero and prints no result without a
CUDA card (or with fewer cards than the cell asks for), without the
program, when it loads JAX or the JAX package, or when the fused path
falls back.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402  (the set-up clock starts before any import)
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every cache a run writes stays at a fixed path inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BENCH_DIR / ".work" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH_DIR / ".work" / "triton"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    from benchmark.harness.cell import Cell, Refused, execute

    cell = Cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"refused: the cell needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import rec_pangu_tpu_torch  # noqa: F401  (without the program there is nothing to run)

    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    except Refused as exc:
        print(f"refused: {exc}", file=sys.stderr)
        return 3
    for name, n in result["numbers"].items():
        print(f"{name} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
