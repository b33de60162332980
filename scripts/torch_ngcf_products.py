"""NGCF's products on the card: each layout of a [U, I] x [., 64] float32
product over R_norm at Gowalla's size (``chip_smoke.gowalla_like``), and
whole NGCF training steps with plain autograd and with the columns'
products rewritten as ``(X^T R^T)^T`` (no copy of R).

    python3 scripts/torch_ngcf_products.py     # on a machine with a CUDA card

Prints one JSON line of medians (ms, CUDA events) for the products, then
one a step variant (host-timed steps after the first, synchronized).
TF32 is off, as in ``chip_smoke.py``.
"""
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
import rec_pangu_tpu_torch.models.graph.ngcf as ngcf_mod  # noqa: E402
from rec_pangu_tpu_torch import get_model  # noqa: E402
from rec_pangu_tpu_torch.data import GeneralGraphDataset  # noqa: E402
from rec_pangu_tpu_torch.train.steps import StandardStep  # noqa: E402

REPS, STEPS = 7, 6


def event_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class ColumnsByRows(torch.autograd.Function):
    """r @ v computed as (v^T r^T)^T; its backward r^T @ g."""

    @staticmethod
    def forward(ctx, r, v):
        ctx.save_for_backward(r)
        return (v.t() @ r.t()).t()

    @staticmethod
    def backward(ctx, grad):
        (r,) = ctx.saved_tensors
        return None, r.t() @ grad


def step_ms(ds, g, label: str) -> None:
    model = get_model("NGCF")(num_user=g.shape[0], num_item=g.shape[1], g=g, seed=1,
                              **cs.NGCF_CONFIG).cuda().train()
    step = StandardStep(model, 1e-3, 1, generator=torch.Generator().manual_seed(0))
    batches = [model.upload_batch(ds.sample(cs.NGCF_BATCH), torch.device("cuda"), train=True)
               for _ in range(STEPS)]
    times = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"variant": label, "step_ms": times,
                      "p50_after_first": statistics.median(times[1:])}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ngcf_products: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    train, _ = cs.gowalla_like(cs.SEED + 800)
    ds = GeneralGraphDataset(train, cs.GOWALLA_USERS, cs.GOWALLA_ITEMS, seed=cs.SEED + 801)
    g = ds.generate_graph("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(g.shape[1], 64, device="cuda", generator=gen)
    y = torch.randn(g.shape[0], 64, device="cuda", generator=gen)
    xt = x.t().contiguous()
    out = {"R@x": event_ms(lambda: g @ x), "(x^T R^T)^T": event_ms(lambda: (x.t() @ g.t()).t()),
           "R@(xt)^T": event_ms(lambda: g @ xt.t()), "R^T@y": event_ms(lambda: g.t() @ y),
           "(y^T R)^T": event_ms(lambda: (y.t() @ g).t()), "mm(R,x)": event_ms(lambda: torch.mm(g, x)),
           "gflop_each": 2 * g.shape[0] * g.shape[1] * 64 / 1e9,
           "card": torch.cuda.get_device_name(0)}
    print(json.dumps(out), flush=True)
    step_ms(ds, g, "autograd R @ X")
    plain = torch.matmul

    def columns_by_rows(a, b):
        if a is g:
            return ColumnsByRows.apply(a, b)
        return plain(a, b)

    ngcf_mod.torch.matmul = columns_by_rows
    try:
        step_ms(ds, g, "R @ X as (X^T R^T)^T, backward R^T @ G")
    finally:
        ngcf_mod.torch.matmul = plain
    return 0


if __name__ == "__main__":
    sys.exit(main())
