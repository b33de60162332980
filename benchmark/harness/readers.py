"""Arithmetic the per-layer metric readers share."""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from benchmark.harness import work

# kernel names of each of the program's kernels in a trace
K1 = ("embedding_lookup_kernel",)
K3 = ("segment_sum_kernel", "tile_starts_kernel", "adam_tile_kernel")
K4F = ("fused_encoder_kernel",)
K4B = ("transpose_weights_kernel", "encoder_rows_kernel", "encoder_attention_kernel",
       "encoder_wgrad_kernel", "sum_slices_kernel")


def device_name(run) -> Optional[str]:
    if run.device.type != "cuda":
        return None
    import torch

    return torch.cuda.get_device_name(run.device)


def roofline(run, kernels: Iterable[str], flop: float = 0.0, moved: float = 0.0
             ) -> Optional[float]:
    """The kernels' share of their roofline in percent: the least time the
    card could take for the traced window's calls (the larger of the FLOP
    over the float32 peak and the bytes over the bandwidth, per call, times
    the calls) over the kernels' device time.  None where the trace holds
    none of them."""
    name = device_name(run)
    seconds = run.trace.kernel_seconds(kernels) if name else 0.0
    if seconds <= 0:
        return None
    least = max(flop / work.peak(work.FP32_PEAK, name), moved / work.peak(work.BANDWIDTH, name))
    return 100.0 * least * run.stats["count"] / seconds


def mfu(run) -> Optional[float]:
    """The whole step's or request's share of the float32 peak: the model
    FLOP a call needs (``run.work["flop"]``) times the calls of the traced
    window, over its length, over the data-sheet rate."""
    name = device_name(run)
    if name is None:
        return None
    rate = work.peak(work.FP32_PEAK, name)
    return 100.0 * run.work["flop"] * run.stats["count"] / run.stats["window_s"] / rate


def k1_bytes(run) -> float:
    """K1's bytes per call over the traced window's calls: each distinct row
    read once, each id's row written, the ids and the offsets read."""
    distinct = {}
    for slot in set(run.stats["slots"]):
        distinct[slot] = len(np.unique(run.family.lookup_ids(run.config, run.pool[slot])))
    mean = sum(distinct[s] for s in run.stats["slots"]) / len(run.stats["slots"])
    w = run.work
    return work.lookup_bytes(w["k1_ids"], w["k1_dim"], w["k1_fields"], mean)


def idle(run) -> Optional[float]:
    """The share of the traced window in which nothing ran on the device."""
    busy = run.trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.trace.window_s)
