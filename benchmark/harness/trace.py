"""Reading a ``torch.profiler`` trace of the measured window in memory.

The window is the benchmark's own ``record_function(WINDOW)`` span.  Device
events are kernels, copies and sets on the card (user annotations mirrored
onto the device are left out); the device is busy where the union of their
intervals lies, so kernels that overlap on two streams count once.  A
kernel's host op is the innermost operator that launched it (the event's
linked correlation id).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch

WINDOW = "bench.window"
# host events of the CUDA runtime, whose correlation ids are counted apart from the ops
RUNTIME = ("cuda", "Activity Buffer")
SCAN = 20_000  # host events looked back through for the one running at a moment
SPANS = ("bench.step", "bench.request")  # the benchmark's own spans around a call


class Trace:
    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        window = [e for e in events if e.name() == WINDOW and e.device_type() != cuda]
        if not window:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        self.t0 = window[0].start_ns()
        self.t1 = self.t0 + window[0].duration_ns()
        self.thread = window[0].start_thread_id()
        self.device: List[Tuple[int, int, str, int]] = []  # (start, end, name, linked op id)
        self.host: List[Tuple[int, int, str]] = []         # host ops and runtime calls
        ops: Dict[int, str] = {}
        for e in events:
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == cuda:
                if e.is_user_annotation() or end <= self.t0 or start >= self.t1:
                    continue
                self.device.append((max(start, self.t0), min(end, self.t1), e.name(),
                                    e.linked_correlation_id()))
            elif e.name() != WINDOW and e.start_thread_id() == self.thread:
                if not (e.is_user_annotation() or e.name().startswith(RUNTIME)):
                    ops[e.correlation_id()] = e.name()
                if end > self.t0 and start < self.t1:
                    self.host.append((start, end, e.name()))
        self.op_of = ops
        self.device.sort()
        self.host.sort()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for start, end, _, _ in self.device:
            if out and start <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], end))
            else:
                out.append((start, end))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernels(self) -> List[Tuple[int, int, str, int]]:
        """Kernel events only: no copies and no sets."""
        return [e for e in self.device if not e[2].startswith(("Memcpy", "Memset"))]

    def kernel_seconds(self, names: Iterable[str]) -> float:
        """Device seconds of the kernels whose name holds any of ``names``."""
        names = tuple(names)
        return sum(b - a for a, b, n, _ in self.device if any(k in n for k in names)) / 1e9

    def op_seconds(self, op: str) -> float:
        """Device seconds of the kernels launched by host operator ``op``."""
        return sum(b - a for a, b, _, c in self.device if self.op_of.get(c) == op) / 1e9

    def top_device_ops(self, k: int = 10) -> List[List]:
        totals: Dict[str, int] = defaultdict(int)
        for a, b, n, _ in self.device:
            totals[short_name(n)] += b - a
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest stretches of the window with nothing on the
        device, each named by the innermost host event running at its
        middle."""
        edges = [self.t0] + [t for iv in self.busy_intervals() for t in iv] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        starts = [h[0] for h in self.host]
        out = []
        for length, start in gaps[:k]:
            mid = start + length // 2
            label = self._host_at(mid, starts)
            out.append([label, length / 1e9])
        return out

    def _host_at(self, t: int, starts: List[int]) -> str:
        best: Optional[Tuple[int, str]] = None
        last = bisect.bisect_right(starts, t) - 1
        for i in range(last, max(last - SCAN, -1), -1):
            start, end, name = self.host[i]
            if end >= t and (best is None or end - start < best[0]):
                best = (end - start, name)
        if best is None:
            return "host (no traced op)"
        return best[1] if best[1] not in SPANS else f"host code in {best[1]} (no traced op)"


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list."""
    head = name.replace("(anonymous namespace)", "anon")
    if head.startswith("void "):
        head = head[5:]
    head = head.split("(")[0].split("<")[0].strip()
    return (head or name)[:80]
