#!/usr/bin/env python3
"""Drive the PyTorch port (rec_pangu_tpu_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   -- requires CUDA; the card as nvidia-smi names it.
2. build    -- builds every CUDA kernel of the package from its sources.
3. kernel   -- each kernel against its plain PyTorch version on the card,
               bit-equal (a gather has no rounding), at the bench shape and
               at edge shapes; median times of the kernel, the plain version
               and one PyTorch library call, and the kernel's byte bound.
4. serving  -- DeepFM at the bench's full width (16 sparse fields x 100,000
               vocab, 9 dense, D=32, MLP (64, 64, 64)) from a checkpoint in
               the JAX package's layout, random weights from a seed: requests
               of 8192 rows through RankTrainer.load_model and
               make_ranking_scorer, checked against the same model on the
               CPU; then evaluate_model on a seeded labelled set.
5. profile  -- torch.profiler over a few more requests: device time by
               operation and the card's idle share.

Then the kernels line, the card's name and power limit as nvidia-smi gives
them, and last {"ok": true, "device": {...}}.

Float32 matmuls are held to full precision for the comparisons:
torch.backends.cuda.matmul.allow_tf32 = False (and the cuDNN flag too).
"""
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import rec_pangu_tpu_torch as port
from rec_pangu_tpu_torch.data import DataLoader
from rec_pangu_tpu_torch.ops.embedding import check_ids, padded_rows
from rec_pangu_tpu_torch.ops.kernels import _build
from rec_pangu_tpu_torch.ops.kernels import embedding_lookup as lookup
from rec_pangu_tpu_torch.serving import make_ranking_scorer
from rec_pangu_tpu_torch.train import RankTrainer, save_checkpoint

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
FIELDS, VOCAB, DENSE, DIM, HIDDEN = 16, 100_000, 9, 32, (64, 64, 64)
BATCH = 8192
WARMUP, REQUESTS = 3, 200  # 200: 20 samples lie beyond the p90
SERVING_ATOL = 1e-5        # f32 matmuls summed in another order on the CPU
TIMING_REPS = 15
PROFILED = 20              # requests traced by the profiler
ID_SETS = 8                # 8 x 16.8 MB of rows: more than the 50 MB L2

# data-sheet memory bandwidth (bytes/s) of the cards this targets
_BANDWIDTH = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
              ("H100", 3.35e12))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peak_bandwidth(name: str) -> float:
    for key, rate in _BANDWIDTH:
        if key in name:
            return rate
    raise RuntimeError(f"no data-sheet bandwidth known for {name!r}")


def median_ms(fns, launches: int = 100, reps: int = TIMING_REPS) -> float:
    """Device time per call: ``launches`` calls, cycling through ``fns``, are
    captured in one CUDA graph; the median over ``reps`` replays, timed by
    CUDA events, is divided by ``launches``.  A replay costs the host one
    launch, so the card never waits on Python between calls; cycling through
    inputs larger than the 50 MB L2 keeps the rows cold."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs require
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def call_ms(fn, reps: int = 200) -> float:
    """Median time of one call from the host's side, launch work included:
    the call, then a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def require_equal(got, want, what: str) -> None:
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        err = (got - want).abs().max().item() if got.shape == want.shape else math.inf
        raise RuntimeError(f"{what}: kernel differs from its plain version "
                           f"(max abs err {err})")


def phase_kernel(bandwidth: float) -> dict:
    """The lookup kernel against its plain version; times at the bench shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = padded_rows(FIELDS * (VOCAB + 1))
    table = torch.randn(rows, DIM, generator=gen, device=dev)
    sparse = torch.randint(0, VOCAB + 1, (BATCH, FIELDS), generator=gen, device=dev,
                           dtype=torch.int32)
    offsets = torch.arange(FIELDS, device=dev, dtype=torch.int32) * (VOCAB + 1)
    out = lookup.fused_embedding_lookup(table, sparse, offsets)
    ref = lookup.fused_embedding_lookup_reference(table, sparse, offsets)
    require_equal(out, ref, f"bench shape {tuple(table.shape)} x {tuple(sparse.shape)}")
    max_abs_err = (out - ref).abs().max().item()

    edges = []
    for dim in (1, 3, 8, 64, 128):
        for batch in (1, 1000):
            r, f = 5000, 3
            flat = torch.randn(r * dim + 1, generator=gen, device=dev)
            # ids reach past both ends of the table: those rows must be zero
            s = torch.randint(-40, r // f + 1800, (batch, f), generator=gen, device=dev,
                              dtype=torch.int32)
            o = torch.arange(f, device=dev, dtype=torch.int32) * (r // f)
            cases = [("aligned", flat[:-1].view(r, dim))]
            if dim % 4 == 0:  # a table 4 bytes off 16-byte alignment: scalar path
                cases.append(("unaligned", flat[1:].view(r, dim)))
            for kind, tt in cases:
                require_equal(lookup.fused_embedding_lookup(tt, s, o),
                              lookup.fused_embedding_lookup_reference(tt, s, o),
                              f"edge D={dim} B={batch} {kind}")
                edges.append(f"D={dim},B={batch},{kind}")

    # timing inputs: ID_SETS id batches, so consecutive calls read other rows
    id_sets = [torch.randint(0, VOCAB + 1, (BATCH, FIELDS), generator=gen, device=dev,
                             dtype=torch.int32) for _ in range(ID_SETS)]
    fused_sets = [s.long() + offsets.long() for s in id_sets]
    lib = torch.nn.functional.embedding(fused_sets[0], table)
    require_equal(lib, lookup.fused_embedding_lookup_reference(
        table, id_sets[0], offsets), "library call")
    n = BATCH * FIELDS
    moved = 2 * n * DIM * 4 + n * 4 + FIELDS * 4  # rows read + written, ids, offsets

    def calls(fn, inputs):
        return [lambda x=x: fn(table, x, offsets) for x in inputs]

    return {
        "name": "embedding_lookup",
        "route": "cuda",
        "source": "rec_pangu_tpu_torch/csrc/embedding_lookup.cu",
        "replaces": "rec_pangu_tpu/ops/kernels/embedding_grad.py:581",
        "max_abs_err": max_abs_err,
        "ms": median_ms(calls(lookup.fused_embedding_lookup, id_sets)),
        "plain_ms": median_ms(calls(lookup.fused_embedding_lookup_reference, id_sets)),
        "bound_ms": moved / bandwidth * 1e3,
        "bound_by": "bytes",
        "library_ms": median_ms([
            lambda x=x: torch.nn.functional.embedding(x, table) for x in fused_sets]),
        "call_ms": call_ms(lambda: lookup.fused_embedding_lookup(
            table, id_sets[0], offsets)),
        "bytes": moved,
        "edge_cases": edges,
    }


def write_checkpoint(path: str) -> dict:
    """A DeepFM checkpoint in the JAX package's layout, made with numpy from
    the seed: flax-named params plus an enc_dict of 16 x 100,000 vocab and 9
    dense columns."""
    rng = np.random.default_rng(SEED)
    enc_dict = {}
    for f in range(FIELDS):
        mapping = {str(i): i for i in range(VOCAB)}
        mapping["vocab_size"] = VOCAB
        enc_dict[f"C{f + 1}"] = mapping
    for d in range(DENSE):
        enc_dict[f"I{d + 1}"] = {"min": 0.0, "max": 1.0}
    rows = padded_rows(FIELDS * (VOCAB + 1))
    params = {"FusedEmbedding_0": {
        "table": (rng.standard_normal((rows, DIM)) * math.sqrt(2.0 / DIM)).astype(np.float32)}}
    mlp, fan_in = {}, FIELDS * DIM + DENSE
    for i, units in enumerate(list(HIDDEN) + [1]):
        bound = 1.0 / math.sqrt(fan_in)
        mlp[f"Dense_{i}"] = {
            "kernel": (rng.standard_normal((fan_in, units))
                       * math.sqrt(2.0 / fan_in)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, units).astype(np.float32)}
        fan_in = units
    params["MLP_0"] = mlp
    save_checkpoint(path, params, None, enc_dict=enc_dict)
    return enc_dict


def make_requests(count: int, seed: int):
    rng = np.random.default_rng(seed)
    # ids up to VOCAB inclusive: the last one is each field's OOV row
    return [{"sparse": rng.integers(0, VOCAB + 1, (BATCH, FIELDS)).astype(np.int32),
             "dense": rng.random((BATCH, DENSE)).astype(np.float32)}
            for _ in range(count)]


class _Arrays:
    """A dataset of encoded arrays, for DataLoader (no DataFrame needed)."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays["sparse"])


def phase_serving(device: str = "cuda"):
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "model.ckpt")
        t0 = time.perf_counter()
        enc_dict = write_checkpoint(path)

        def new_model():
            return port.get_model("DeepFM")(enc_dict=enc_dict, embedding_dim=DIM,
                                            hidden_units=HIDDEN)

        model = new_model()
        trainer = RankTrainer(device=device)
        trainer.load_model(model, path)
        score = make_ranking_scorer(model, device=device)
        cpu_model = new_model()
        RankTrainer(device="cpu").load_model(cpu_model, path)
        cpu_score = make_ranking_scorer(cpu_model, device="cpu")
        setup_s = time.perf_counter() - t0

    requests = make_requests(WARMUP + REQUESTS, SEED + 1)
    # the main path: every count is 0 just before it and read just after
    lookup.LAUNCHES = 0
    preds, latencies = [], []
    for i, req in enumerate(requests):
        t0 = time.perf_counter()
        pred = score(req)
        if i >= WARMUP:
            latencies.append(time.perf_counter() - t0)
        preds.append(pred)
    launches = {"embedding_lookup": lookup.LAUNCHES}
    if launches["embedding_lookup"] != len(requests):
        raise RuntimeError(f"expected one lookup launch per request, got {launches} "
                           f"for {len(requests)} requests")

    max_err = 0.0
    for req, pred in zip(requests[:3], preds[:3]):
        want = cpu_score(req)
        if pred.shape != (BATCH,) or not np.all(np.isfinite(pred)):
            raise RuntimeError(f"bad predictions: shape {pred.shape}")
        max_err = max(max_err, float(np.abs(pred - want).max()))
    if max_err > SERVING_ATOL:
        raise RuntimeError(f"card predictions differ from the CPU's by {max_err} "
                           f"> {SERVING_ATOL}")

    # a labelled set whose labels are drawn from the model's own scores, so a
    # sane model ranks them above chance
    eval_reqs = make_requests(4, SEED + 2)
    rng = np.random.default_rng(SEED + 3)
    arrays = {k: np.concatenate([r[k] for r in eval_reqs]) for k in ("sparse", "dense")}
    arrays["label"] = (rng.random(len(arrays["sparse"]))
                       < np.concatenate([score(r) for r in eval_reqs])).astype(np.float32)
    metrics = trainer.evaluate_model(model, DataLoader(_Arrays(arrays), batch_size=BATCH))
    if not (0.0 <= metrics["roc_auc_score"] <= 1.0 and math.isfinite(metrics["log_loss"])):
        raise RuntimeError(f"bad metrics {metrics}")

    p50 = statistics.median(latencies)
    summary = {
        "phase": "serving", "model": "DeepFM", "batch": BATCH, "fields": FIELDS,
        "vocab": VOCAB, "dense": DENSE, "dim": DIM, "hidden": list(HIDDEN),
        "table_rows": int(model.embedding.table.shape[0]),
        "requests": REQUESTS, "warmup": WARMUP, "launches": launches,
        "max_abs_err_vs_cpu": max_err, "atol": SERVING_ATOL,
        "p50_ms": p50 * 1e3, "p90_ms": float(np.percentile(latencies, 90)) * 1e3,
        "examples_per_s": REQUESTS * BATCH / sum(latencies),
        "eval": metrics, "setup_s": setup_s,
    }
    return summary, model, requests[WARMUP:WARMUP + PROFILED]


def phase_profile(model, requests) -> dict:
    """Where a request's time goes.  Host stages, each ended by a
    synchronize: the id check, the check plus upload, the model's forward,
    the copy back.  Then torch.profiler over the scorer: device time by
    operation and the card's idle share of the wall time (both under the
    profiler's own overhead)."""
    from torch.profiler import ProfilerActivity, profile

    dev = next(model.parameters()).device
    rows = model.embedding.table.shape[0]
    stages = {"check_ids": [], "check_and_upload": [], "forward": [], "download": []}
    for req in requests:
        t0 = time.perf_counter()
        check_ids(model.spec, req["sparse"], rows)
        t1 = time.perf_counter()
        inputs = model.upload_batch(req, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            pred = model(inputs, train=False)["pred"]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pred.reshape(-1).cpu().numpy()
        t4 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[key].append(dt)

    score = make_ranking_scorer(model, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for req in requests:
            score(req)
        wall_s = time.perf_counter() - t0
    # device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same device time and would count it twice
    ops = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
           if e.self_device_time_total > 0 and e.device_type != torch.autograd.DeviceType.CPU]
    ops.sort(key=lambda op: -op[1])
    busy_s = sum(op[1] for op in ops) / 1e6
    n = len(requests)
    return {
        "phase": "profile", "requests": n,
        "host_stage_p50_ms": {k: statistics.median(v) * 1e3 for k, v in stages.items()},
        "wall_ms_per_request": wall_s * 1e3 / n,
        "device_busy_ms_per_request": busy_s * 1e3 / n,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "device_ops": [{"op": k[:80], "ms_per_request": us / 1e3 / n, "calls": c}
                       for k, us, c in ops[:10]],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": False})

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(os.path.relpath(p, ROOT) for p in libs.values())})

    row = phase_kernel(peak_bandwidth(kind))
    emit({"phase": "kernel", **row})

    serving, model, profiled = phase_serving()
    emit(serving)
    emit(phase_profile(model, profiled))

    row["launches"] = serving["launches"][row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
