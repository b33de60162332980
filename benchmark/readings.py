"""The readings the correctness limits are set from, for one cell.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 21,22,23] [--fault half_batch] [--out <file>]

For each of ``--seeds``, a whole run of the cell (set-up, a window of
``--seconds``, the check) gives the program's numbers: the lower readings.
For each of ``--control-seeds``, the mode's ``control`` (the plain
reference computed in the precision below the configuration's, in the
program's place) and each ``--fault`` (a ``fault_<name>`` of the mode,
planted in the reference put in the program's place) give the upper
readings.  One JSON line a reading, to standard output and to ``--out``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    from benchmark.harness.cell import Cell, Run, execute, precision

    cell = Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(kind: str, seed: int, numbers: dict, **extra) -> None:
        line = json.dumps({"cell": cell.name, "kind": kind, "seed": seed, "numbers": numbers,
                           **extra})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in args.seeds:
        t = time.perf_counter()
        result = execute(cell, seed, args.seconds, False, "cuda", t)
        emit("program", seed, {k: n["value"] for k, n in result["numbers"].items()},
             correct=result["correct"], metrics=result["metrics"])
    for seed in args.control_seeds:
        for kind in ["control"] + [f"fault_{f}" for f in args.fault]:
            run = Run(cell, seed, "cuda", False)
            with precision(cell.config["allow_tf32"]):
                numbers = getattr(cell.mode, kind)(run)
            emit(kind, seed, numbers)
            del run
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
