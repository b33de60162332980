"""CCPM's k-max pooling on one CUDA card, in the port's form and two others.

Times ``ops/pooling.kmax_pooling`` (every step along the pooled axis) at
the three poolings of CCPM at the bench's width ([8192, 21, 32, 4] to 14,
[8192, 18, 32, 4] to 5, [8192, 7, 32, 2] to 3), beside the same steps on the
axis moved last with the kept positions gathered after a stable sort, or
scattered to their slots, and beside ``torch.topk`` alone; holds every
form's output equal to the port's on integer data full of ties.  Times are
CUDA events around 20 calls after 3 warm ones.  Prints one JSON line with
the card's name and power limit.

    python3 scripts/torch_kmax_pooling.py
"""
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from rec_pangu_tpu_torch.ops.pooling import kmax_pooling  # noqa: E402

SHAPES = (((8192, 21, 32, 4), 14), ((8192, 18, 32, 4), 5), ((8192, 7, 32, 2), 3))


def _kept(moved: torch.Tensor, k: int) -> torch.Tensor:
    """The kept positions along the last axis (the port's tie rule)."""
    kth = torch.topk(moved, k, dim=-1).values[..., -1:]
    gt, eq = moved > kth, moved == kth
    need = k - gt.sum(dim=-1, keepdim=True)
    return gt | (eq & (torch.cumsum(eq, dim=-1) <= need))


def moved_sort(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    moved = x.movedim(dim, -1)
    pos = torch.sort((~_kept(moved, k)).to(torch.uint8), dim=-1, stable=True).indices[..., :k]
    return torch.gather(moved, -1, pos).movedim(-1, dim)


def moved_scatter(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    moved = x.movedim(dim, -1)
    sel = _kept(moved, k)
    slot = torch.where(sel, torch.cumsum(sel, dim=-1) - 1, k)
    out = moved.new_zeros(*moved.shape[:-1], k + 1).scatter(-1, slot, moved)
    return out[..., :k].movedim(-1, dim)


def event_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kmax_pooling: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for shape, k in SHAPES:
        x = torch.randint(0, 50, shape, generator=gen, device="cuda").float()
        want = kmax_pooling(x, k, 1)
        for fn in (moved_sort, moved_scatter):
            if not torch.equal(fn(x, k, 1), want):
                raise RuntimeError(f"{fn.__name__} differs from kmax_pooling at {shape}")
        rows[f"{list(shape)}->{k}"] = {
            "kmax_pooling_ms": event_ms(lambda: kmax_pooling(x, k, 1)),
            "moved_sort_ms": event_ms(lambda: moved_sort(x, k, 1)),
            "moved_scatter_ms": event_ms(lambda: moved_scatter(x, k, 1)),
            "topk_alone_ms": event_ms(lambda: torch.topk(x, k, dim=1))}
    print(json.dumps({"kmax_pooling": rows, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
