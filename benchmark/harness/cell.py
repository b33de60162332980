"""One run of one cell: set-up, the measured window, the checks and the
result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  The
harness finds everything by name: ``configs/<config>.json`` (its
``family`` names ``families/<family>.py`` and its ``reference`` names
``reference/<reference>.py``), ``traffic/<traffic>.json`` (its ``mode``
names ``modes/<mode>.py``), ``limits/<cell>.json`` (the limit of each number
the correctness check compares) and ``metrics/<metric>.py`` (a per-layer
metric's reader).  A new cell, traffic mix or metric is new files.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

from benchmark.harness import data
from benchmark.harness.trace import WINDOW, Trace

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
WORK_DIR = BENCH_DIR / ".work"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rec_pangu_tpu")
SWITCHES = "REC_PANGU_TPU_"  # the program's environment switches (bf16 moments, paths off)
KERNELS = "rec_pangu_tpu_torch.ops.kernels"
TRACE_SECONDS = 6.0  # the traced slice of a --trace 1 run's window
THREADS = 4          # the process's intra-op threads
GIB = 2 ** 30


class Refused(RuntimeError):
    """A run that may report nothing: no card, a forbidden module, or a
    fused path that fell back."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``<benchmark>/<kind>/<name>.py``: a package module where the name is
    an identifier, else loaded from its file (metric names hold dots)."""
    if name.isidentifier():
        return importlib.import_module(f"benchmark.{kind}.{name}")
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}._" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A workload of ``BENCHMARK.json`` with the files it names."""

    def __init__(self, bench: dict, name: str, overrides: Optional[dict] = None):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{[w['name'] for w in bench['workloads']]}")
        overrides = overrides or {}
        self.name = name
        self.workload = found[0]
        self.chips = int(self.workload["chips"])
        self.config = {**load_json(BENCH_DIR / "configs" / f"{self.workload['config']}.json"),
                       **overrides.get("config", {})}
        self.traffic = {**load_json(BENCH_DIR / "traffic" / f"{self.workload['traffic']}.json"),
                        **overrides.get("traffic", {})}
        self.limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
        self.family = load_module("families", self.config["family"])
        self.mode = load_module("modes", self.traffic["mode"])
        self.reference = load_module("reference", self.config["reference"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if "workloads" not in m or name in m["workloads"]]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name] if m["moves"] in reported else [])]


class Run:
    """The state of one run, shared by the mode, the checks and the metric
    readers."""

    def __init__(self, cell: Cell, seed: int, device, trace: bool,
                 t_start: Optional[float] = None):
        self.cell = cell
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.phases: List[list] = []  # [what, seconds since the process began] of set-up
        self.config, self.traffic = cell.config, cell.traffic
        self.family, self.reference = cell.family, cell.reference
        self.seed = int(seed)
        self.fit_seed = data.sub_seed(seed, "fit")
        self.device = torch.device(device)
        self.traced = bool(trace)
        self.workdir = str(WORK_DIR)
        self.pool: List[dict] = []
        self.program: dict = {}     # what the timed path produced, for the check
        self.work: Dict[str, float] = {}  # a step's or request's work (family)
        self.stats: dict = {}       # the window: count, rows, window_s, ...
        self.trace: Optional[Trace] = None
        self.upload_s: Optional[float] = None

    def mark(self, what: str) -> None:
        """Note that a stage of set-up has ended."""
        self.phases.append([what, round(time.perf_counter() - self.t_start, 3)])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        """A profiler span in a traced run, else nothing."""
        if not self.traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def free_program(self) -> None:
        for key in ("model", "trainer", "retrieve"):
            self.__dict__.pop(key, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


@contextlib.contextmanager
def precision(allow_tf32: bool):
    """torch's TF32 switches for matrix products and cuDNN, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(allow_tf32)
    torch.backends.cudnn.allow_tf32 = bool(allow_tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def install_weights(model, run: Run):
    """Move ``model`` to the run's device and overwrite every parameter with
    the benchmark's weights for the run's seed (the reference's names and
    shapes, drawn by ``data.make_weights``)."""
    model.to(run.device)
    weights = data.make_weights(run.reference.weight_specs(run.config), run.seed, run.device)
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the program's parameters {sorted(set(params) ^ set(weights))} are "
                         f"not the reference's")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: the program's shape {tuple(p.shape)}, the "
                                 f"reference's {tuple(weights[name].shape)}")
            p.copy_(weights[name])
    del weights
    return model


def set_switches() -> List[str]:
    """The program's environment switches that are set: a run takes the
    path its configuration states, so it refuses any."""
    return sorted(k for k in os.environ if k.startswith(SWITCHES))


def check_precision(config: dict, tensors: Dict[str, torch.Tensor]) -> None:
    """Refuse a run whose weights or optimizer state are held in another
    floating type than the configuration's ``precision``."""
    want = getattr(torch, config["precision"])
    off = {name: str(t.dtype) for name, t in tensors.items()
           if t.is_floating_point() and t.dtype != want}
    if off:
        raise Refused(f"state held below the configuration's {config['precision']}: {off}")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run may not load, compared
    as whole names (``rec_pangu_tpu_torch`` is not ``rec_pangu_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def launch_counts(spec: Dict[str, int]) -> Dict[str, int]:
    counts = {}
    for key in spec:
        module, attr = key.rsplit(".", 1)
        counts[key] = int(getattr(importlib.import_module(f"{KERNELS}.{module}"), attr))
    return counts


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run; returns the result line.  Raises ``Refused`` where the run
    may report nothing."""
    if set_switches():
        raise Refused(f"the program's switches are set in the environment: {set_switches()}")
    torch.set_num_threads(THREADS)
    run = Run(cell, seed, device, trace, t_start)
    run.mark("imports")
    mode = cell.mode
    with precision(cell.config["allow_tf32"]):
        mode.setup(run)
        spec = cell.config["launches"][cell.traffic["mode"]] if run.device.type == "cuda" else {}
        before = launch_counts(spec)
        setup_s = time.perf_counter() - t_start
        setup_peak = memory_peak(run.device)
        if run.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(run.device)
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if run.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                with torch.profiler.record_function(WINDOW):
                    run.stats = mode.window(run, min(seconds, TRACE_SECONDS))
            run.trace = Trace(prof)
            del prof
        else:
            run.stats = mode.window(run, seconds)
        window_peak = memory_peak(run.device)
        after = launch_counts(spec)
        found = forbidden_modules()
        if found:
            raise Refused(f"modules the run may not load are loaded: {found}")
        count = run.stats["count"]
        wrong = {k: (after[k] - before[k], per * count) for k, per in spec.items()
                 if after[k] - before[k] != per * count}
        if wrong:
            raise Refused(f"the fused path fell back: launches (got, want) over {count} "
                          f"{cell.traffic['mode']} calls: {wrong}")
        if trace:
            mode.after_trace(run)
        e2e = mode.end_to_end(run)
        run.free_program()
        numbers = mode.check(run)
    if forbidden_modules():
        raise Refused(f"modules the run may not load are loaded: {forbidden_modules()}")

    limits = cell.limits
    correct = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    result = {"correct": correct, "attempted": count, "failed": 0}
    if trace:
        values = {}
        for m in cell.per_layer:
            v = load_module("metrics", m["name"]).read(run)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = values
    else:
        e2e["peak_mem_gib"] = window_peak / GIB
        e2e["setup_s"] = setup_s
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(10),
                               "idle_gaps": run.trace.idle_gaps(10)}
    result["device"] = dev
    result["setup_phases"] = run.phases
    result["numbers"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return result
