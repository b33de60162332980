#!/usr/bin/env python3
"""Drive the PyTorch port (rec_pangu_tpu_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   -- requires CUDA; the card as nvidia-smi names it.
2. build    -- builds every CUDA kernel of the package from its sources.
3. kernel   -- each kernel against its plain PyTorch version on the card, at
               the bench shape and at edge shapes, and run twice for the same
               bits; median times of the kernel, the plain version and one
               PyTorch library call, and the kernel's byte bound.  The lookup
               (a gather) is bit-equal; the table gradient and the fused Adam
               sum in another order than the plain version's atomics, within
               the rounding bound stated at ``sum_tolerance``.
4. serving  -- DeepFM at the bench's full width (16 sparse fields x 100,000
               vocab, 9 dense, D=32, MLP (64, 64, 64)) from a checkpoint in
               the JAX package's layout, random weights from a seed: requests
               of 8192 rows through RankTrainer.load_model and
               make_ranking_scorer, checked against the same model on the
               CPU; then evaluate_model on a seeded labelled set.
5. profile  -- torch.profiler over a few more requests: device time by
               operation and the card's idle share.
6. training -- RankTrainer.fit from the same checkpoint, 2 epochs of 8192-row
               batches whose labels are drawn from the model's own scores,
               with validation, checkpoints and early stopping: the fused
               step (K1 + K3).  Then a few standard steps (K1 + K2 +
               torch.optim.Adam).  Step times and examples/s for both.
7. card_vs_cpu -- the first three fused steps on the card and on the CPU.
8. train_profile -- torch.profiler over a few fused training steps.

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
from rec_pangu_tpu_torch.ops.kernels import embedding_grad as grad
from rec_pangu_tpu_torch.ops.kernels import embedding_lookup as lookup
from rec_pangu_tpu_torch.ops.kernels import fused_adam as adam
from rec_pangu_tpu_torch.serving import make_ranking_scorer
from rec_pangu_tpu_torch.train import RankTrainer, save_checkpoint
from rec_pangu_tpu_torch.train.fused_update import maybe_enable_fused_update

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
FIELDS, VOCAB, DENSE, DIM, HIDDEN = 16, 100_000, 9, 32, (64, 64, 64)
BATCH = 8192
WARMUP, REQUESTS = 3, 200  # 200: 20 samples lie beyond the p90
SERVING_ATOL = 1e-5        # f32 matmuls summed in another order on the CPU
TIMING_REPS = 15
PROFILED = 20              # requests traced by the profiler
ID_SETS = 8                # 8 x 16.8 MB of rows: more than the 50 MB L2
LR = 1e-3
EPOCHS, TRAIN_BATCHES, VALID_BATCHES = 2, 24, 4  # 24 steps an epoch
STD_STEPS = 10             # standard-step leg
CPU_STEPS = 3              # fused steps held against the CPU
TRAIN_PROFILED = 10        # fused steps traced by the profiler
LOSS_RTOL = 1e-5           # card against CPU: losses over three steps
DENSE_ATOL = 1e-5          # card against CPU: dense parameters after one step
TABLE_ATOL = 1e-6          # ... the table, on all but HANDFUL elements
HANDFUL = 64
EDGE_ROWS = 3001           # edge tables: not a multiple of any tile

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


def sum_tolerance(ids, rows, num_rows: int):
    """Per-element bound on how far two f32 sums of the same terms, taken in
    two orders, may differ: each lies within (k-1) * 2^-24 * sum|x| of the
    exact sum of its k terms, so the two within twice that (1% margin for
    the second-order term).  Returns (bound [num_rows, D], hits [num_rows])."""
    absum = grad.table_grad_reference(ids, rows.abs(), num_rows)
    hits = grad.table_grad_reference(ids, torch.ones_like(rows[:, :1]), num_rows)[:, 0]
    return 2.02 * (hits - 1).clamp(min=0)[:, None] * 2.0 ** -24 * absum, hits


def require_within(got, want, bound, what: str) -> float:
    torch.cuda.synchronize()
    err = (got - want).abs()
    if got.shape != want.shape or bool((err > bound).any()):
        raise RuntimeError(f"{what}: kernel differs from its plain version beyond the "
                           f"rounding bound (max abs err {err.max().item()})")
    return err.max().item() if err.numel() else 0.0


def edge_ids(kind: str, n: int, num_rows: int, gen):
    """Fused ids of one edge case on an EDGE_ROWS table."""
    dev = gen.device
    if kind == "empty":
        return torch.zeros(0, dtype=torch.int32, device=dev)
    if kind == "all_equal":
        return torch.full((n,), num_rows // 2, dtype=torch.int32, device=dev)
    if kind == "one_chunk":  # fewer ids than one warp's chunk: a single level
        return torch.randint(0, num_rows, (20,), generator=gen, device=dev, dtype=torch.int32)
    if kind == "first_last_tiles":  # rows 0..2 and the last 3 rows only
        ids = torch.randint(0, 6, (n,), generator=gen, device=dev, dtype=torch.int32)
        return torch.where(ids < 3, ids, ids - 6 + num_rows)
    # duplicates, and ids past both ends (they add nothing)
    return torch.randint(-20, num_rows + 20, (n,), generator=gen, device=dev, dtype=torch.int32)


EDGE_KINDS = ("random_out_of_range", "empty", "one_chunk", "all_equal", "first_last_tiles")
LOW_CARD = (2, 2, 7, 24)   # fields with few values (a flag, a weekday, an hour)
ZIPF_A = 1.2               # the other fields: Zipf over the vocabulary
SKEW_LAUNCHES = 10         # graphs of 10 calls at skewed ids


def skewed_id_sets(num_rows: int, dev) -> dict:
    """Fused ids at the bench shape with long runs of equal ids: every id
    equal, and a mix of LOW_CARD-valued fields beside Zipf fields."""
    rng = np.random.default_rng(SEED + 30)
    cols = [rng.integers(0, c, BATCH) for c in LOW_CARD]
    cols += [np.minimum(rng.zipf(ZIPF_A, BATCH) - 1, VOCAB)
             for _ in range(FIELDS - len(LOW_CARD))]
    sparse = torch.from_numpy(np.stack(cols, 1).astype(np.int32)).to(dev)
    offsets = torch.arange(FIELDS, device=dev, dtype=torch.int32) * (VOCAB + 1)
    return {"all_equal": torch.full((BATCH * FIELDS,), num_rows // 2, dtype=torch.int32,
                                    device=dev),
            "low_card_zipf": lookup.fused_ids(sparse, offsets)}


def bench_table_inputs(gen):
    """The bench shape: ID_SETS fused id batches drawn as the serving phase
    draws ids (duplicates included), one batch of cotangent rows."""
    dev = gen.device
    rows = padded_rows(FIELDS * (VOCAB + 1))
    offsets = torch.arange(FIELDS, device=dev, dtype=torch.int32) * (VOCAB + 1)
    id_sets = [lookup.fused_ids(torch.randint(0, VOCAB + 1, (BATCH, FIELDS), generator=gen,
                                              device=dev, dtype=torch.int32), offsets)
               for _ in range(ID_SETS)]
    cot = torch.randn(BATCH * FIELDS, DIM, generator=gen, device=dev) * 1e-3
    return rows, id_sets, cot


def phase_table_grad(bandwidth: float) -> dict:
    """K2: the dense table gradient against index_add_ on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    num_rows, id_sets, cot = bench_table_inputs(gen)
    ids = id_sets[0]
    out = grad.table_grad(ids, cot, num_rows)
    require_equal(grad.table_grad(ids, cot, num_rows), out, "bench shape, run twice")
    bound, hits = sum_tolerance(ids, cot, num_rows)
    max_abs_err = require_within(out, grad.table_grad_reference(ids, cot, num_rows), bound,
                                 f"bench shape [{num_rows}, {DIM}] x {ids.numel()} ids")
    edges = []
    for dim in (1, 8, 64, 128):
        rows = torch.randn(5000, dim, generator=gen, device="cuda")
        for kind in EDGE_KINDS:
            e_ids = edge_ids(kind, 5000, EDGE_ROWS, gen)
            r = rows[:e_ids.numel()]
            got = grad.table_grad(e_ids, r, EDGE_ROWS)
            require_equal(grad.table_grad(e_ids, r, EDGE_ROWS), got, f"D={dim} {kind} twice")
            require_within(got, grad.table_grad_reference(e_ids, r, EDGE_ROWS),
                           sum_tolerance(e_ids, r, EDGE_ROWS)[0], f"edge D={dim} {kind}")
            edges.append(f"D={dim},{kind}")
    skewed = {}
    for kind, x in skewed_id_sets(num_rows, cot.device).items():
        got = grad.table_grad(x, cot, num_rows)
        require_equal(grad.table_grad(x, cot, num_rows), got, f"{kind}, run twice")
        x_bound, x_hits = sum_tolerance(x, cot, num_rows)
        require_within(got, grad.table_grad_reference(x, cot, num_rows), x_bound,
                       f"bench shape, {kind}")
        skewed[kind] = {"max_hits_per_row": int(x_hits.max().item()), "ms": median_ms(
            [lambda: grad.table_grad(x, cot, num_rows)], SKEW_LAUNCHES)}

    n = ids.numel()
    moved = num_rows * DIM * 4 + n * DIM * 4 + n * 4  # grad written; rows, ids read
    sorted_sets = [grad.sort_ids(x) for x in id_sets]
    long_sets = [x.long() for x in id_sets]
    lib = torch.zeros(num_rows, DIM, device="cuda")
    return {
        "name": "embedding_grad", "route": "cuda",
        "source": "rec_pangu_tpu_torch/csrc/embedding_grad.cu",
        "replaces": "rec_pangu_tpu/ops/kernels/embedding_grad.py:493",
        "max_abs_err": max_abs_err,
        "tolerance": "per element 2(k-1)*2^-24*sum|x| over its k terms (sum order)",
        "max_hits_per_row": int(hits.max().item()),
        "ms": median_ms([lambda x=x: grad.table_grad(x, cot, num_rows) for x in id_sets]),
        "kernel_only_ms": median_ms([lambda s=s: grad.launch(*s, cot, num_rows)
                                     for s in sorted_sets]),
        "sort_ms": median_ms([lambda x=x: grad.sort_ids(x) for x in id_sets]),
        "plain_ms": median_ms([lambda x=x: grad.table_grad_reference(x, cot, num_rows)
                               for x in id_sets]),
        "bound_ms": moved / bandwidth * 1e3, "bound_by": "bytes",
        "library_ms": median_ms([lambda x=x: lib.zero_().index_add_(0, x, cot)
                                 for x in long_sets]),
        "library": "torch.zeros(V, D).index_add_(0, ids, rows) (atomics)",
        "call_ms": call_ms(lambda: grad.table_grad(ids, cot, num_rows)),
        "bytes": moved, "edge_cases": edges, "skewed": skewed,
    }


def adam_state(num_rows: int, dim: int, gen):
    p = torch.randn(num_rows, dim, generator=gen, device="cuda") * 0.25
    m = torch.randn(num_rows, dim, generator=gen, device="cuda") * 1e-4
    v = torch.rand(num_rows, dim, generator=gen, device="cuda") * 1e-8
    return p, m, v


def check_adam_step(ids, rows, state, hyper, what: str) -> float:
    """One K3 step from ``state`` against the plain version from the same
    state; run twice for the same bits.  Rows hit at most once sum the same
    terms in the same order: bit-equal.  Rows hit more often: the moments
    within the gradient's sum bound (scaled by 1-b1, resp. 2|g|(1-b2)) plus
    two ulps, the table within 2*lr (a gradient within rounding of zero may
    change sign, and Adam's step is lr*m_hat/(sqrt(v_hat)+eps)).
    Returns the largest difference over p, m and v."""
    lr, b1, b2 = (float(x) for x in hyper[:3])
    num_rows = state[0].shape[0]
    outs = []
    for _ in range(2):
        p, m, v = (t.clone() for t in state)
        adam.planned_adam_update(ids, rows, p, m, v, hyper)
        outs.append((p, m, v))
    for a, b in zip(*outs):
        require_equal(a, b, f"{what}, run twice")
    ref = [t.clone() for t in state]
    adam.planned_adam_update_reference(ids, rows, *ref, hyper)
    g_bound, hits = sum_tolerance(ids, rows, num_rows)
    once = (hits <= 1)[:, None]
    g = grad.table_grad_reference(ids, rows, num_rows).abs()
    bounds = (torch.full_like(g, 2 * lr),
              (1 - b1) * g_bound + 2 ** -22 * ref[1].abs(),
              (1 - b2) * (2 * g + g_bound) * g_bound + 2 ** -22 * ref[2].abs())
    err = 0.0
    for name, got, want, bound in zip("pmv", outs[0], ref, bounds):
        err = max(err, require_within(got, want, torch.where(once, 0.0, bound),
                                      f"{what}: {name}"))
    return err


def phase_fused_adam(bandwidth: float) -> dict:
    """K3: the fused table Adam against its plain version on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    num_rows, id_sets, cot = bench_table_inputs(gen)
    state = adam_state(num_rows, DIM, gen)
    max_abs_err = 0.0
    # three consecutive steps with other ids each: absent rows decay
    for t in (1, 2, 3):
        hyper = adam.adam_hyper(t, LR)
        max_abs_err = max(max_abs_err, check_adam_step(
            id_sets[t - 1], cot, state, hyper, f"bench shape, step {t}"))
        adam.planned_adam_update(id_sets[t - 1], cot, *state, hyper)
    edges = []
    for dim in (1, 8, 64, 128):
        e_state = adam_state(EDGE_ROWS, dim, gen)
        rows = torch.randn(5000, dim, generator=gen, device="cuda") * 1e-3
        for kind in EDGE_KINDS:
            e_ids = edge_ids(kind, 5000, EDGE_ROWS, gen)
            check_adam_step(e_ids, rows[:e_ids.numel()], e_state, adam.adam_hyper(2, LR),
                            f"edge D={dim} {kind}")
            edges.append(f"D={dim},{kind}")

    ids = id_sets[0]
    n = ids.numel()
    hyper = adam.adam_hyper(4, LR)
    p, m, v = state
    skewed = {}
    for kind, x in skewed_id_sets(num_rows, cot.device).items():
        max_abs_err = max(max_abs_err, check_adam_step(x, cot, state, hyper,
                                                       f"bench shape, {kind}"))
        skewed[kind] = {"ms": median_ms(
            [lambda: adam.planned_adam_update(x, cot, p, m, v, hyper)], SKEW_LAUNCHES)}
    moved = 6 * num_rows * DIM * 4 + n * DIM * 4 + n * 4  # p, m, v read and written; rows, ids read
    sorted_sets = [grad.sort_ids(x) for x in id_sets]
    long_sets = [x.long() for x in id_sets]
    lib_p = torch.nn.Parameter(p.clone())
    lib_p.grad = torch.zeros_like(p)
    lib_opt = torch.optim.Adam([lib_p], lr=LR, betas=(0.9, 0.999), eps=1e-8, fused=True,
                               capturable=True)

    def library(x):
        lib_p.grad.zero_().index_add_(0, x, cot)
        lib_opt.step()

    return {
        "name": "fused_adam", "route": "cuda",
        "source": "rec_pangu_tpu_torch/csrc/fused_adam.cu",
        "replaces": "rec_pangu_tpu/ops/kernels/fused_adam.py:54",
        "max_abs_err": max_abs_err,
        "tolerance": "rows hit <= once bit-equal; more: m, v within the gradient's sum "
                     "bound, p within 2*lr",
        "ms": median_ms([lambda x=x: adam.planned_adam_update(x, cot, p, m, v, hyper)
                         for x in id_sets]),
        "kernel_only_ms": median_ms([lambda s=s: adam.launch(*s, cot, p, m, v, hyper)
                                     for s in sorted_sets]),
        "plain_ms": median_ms([lambda x=x: adam.planned_adam_update_reference(
            x, cot, p, m, v, hyper) for x in id_sets]),
        "bound_ms": moved / bandwidth * 1e3, "bound_by": "bytes",
        "library_ms": median_ms([lambda x=x: library(x) for x in long_sets]),
        "library": "index_add_ into a zeroed gradient, then torch.optim.Adam(fused=True).step",
        "call_ms": call_ms(lambda: adam.planned_adam_update(ids, cot, p, m, v, hyper)),
        "bytes": moved, "edge_cases": edges, "skewed": skewed,
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


def load_model(path: str, enc_dict: dict, device: str):
    """A DeepFM of the bench's width loaded from ``path`` onto ``device``."""
    model = port.get_model("DeepFM")(enc_dict=enc_dict, embedding_dim=DIM,
                                     hidden_units=HIDDEN)
    RankTrainer(device=device).load_model(model, path)
    return model


def phase_serving(path: str, enc_dict: dict, device: str = "cuda"):
    t0 = time.perf_counter()
    model = load_model(path, enc_dict, device)
    trainer = RankTrainer(device=device)
    score = make_ranking_scorer(model, device=device)
    cpu_score = make_ranking_scorer(load_model(path, enc_dict, "cpu"), device="cpu")
    setup_s = time.perf_counter() - t0

    requests = make_requests(WARMUP + REQUESTS, SEED + 1)
    # the main path: every count is 0 just before it and read just after
    reset_launches()
    preds, latencies = [], []
    for i, req in enumerate(requests):
        t0 = time.perf_counter()
        pred = score(req)
        if i >= WARMUP:
            latencies.append(time.perf_counter() - t0)
        preds.append(pred)
    launches = read_launches()
    require_launches(launches, {"embedding_lookup": len(requests), "embedding_grad": 0,
                                "fused_adam": 0}, "serving")

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
    return summary, model, score, requests[WARMUP:WARMUP + PROFILED]


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
    busy_s, ops = profile_ops(prof, len(requests), "request")
    n = len(requests)
    return {
        "phase": "profile", "requests": n,
        "host_stage_p50_ms": {k: statistics.median(v) * 1e3 for k, v in stages.items()},
        "wall_ms_per_request": wall_s * 1e3 / n,
        "device_busy_ms_per_request": busy_s * 1e3 / n,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "device_ops": ops,
    }


def labelled_loader(score, batches: int, seed: int) -> DataLoader:
    """``batches`` seeded batches whose labels are drawn from ``score``."""
    reqs = make_requests(batches, seed)
    rng = np.random.default_rng(seed + 100)
    arrays = {k: np.concatenate([r[k] for r in reqs]) for k in ("sparse", "dense")}
    arrays["label"] = (rng.random(len(arrays["sparse"]))
                       < np.concatenate([score(r) for r in reqs])).astype(np.float32)
    return DataLoader(_Arrays(arrays), batch_size=BATCH)


def reset_launches() -> None:
    lookup.LAUNCHES = grad.LAUNCHES = adam.LAUNCHES = 0


def read_launches() -> dict:
    return {"embedding_lookup": lookup.LAUNCHES, "embedding_grad": grad.LAUNCHES,
            "fused_adam": adam.LAUNCHES}


def require_launches(got: dict, want: dict, what: str) -> None:
    if got != want:
        raise RuntimeError(f"{what}: kernel launches {got}, expected {want}")


def timed_fit(trainer: RankTrainer, model, train_loader, valid_loader, epochs: int,
              device: str):
    """trainer.fit, each step timed from the host batch to the end of its
    device work (a synchronize after each step: the times exclude the overlap
    of one step's host work with the previous step's device work).  Returns
    (train metric, step seconds, step losses)."""
    inner = trainer._step
    times, losses = [], []

    def step(batch):
        t0 = time.perf_counter()
        out = inner(batch)
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(out["loss"].detach())
        return out

    trainer._step = step
    metric = trainer.fit(model, train_loader, valid_loader, epoch=epochs, lr=LR,
                         use_earlystopping=valid_loader is not None,
                         monitor_metric="roc_auc_score", log_rounds=10 ** 9)
    del trainer._step  # the trainer's own step again
    return metric, times, [float(x) for x in losses]


def step_stats(times, rows: int) -> dict:
    """Over the steps after the first, which also pays one-time set-up (the
    optimizer's state, the GEMM and sort libraries' first calls)."""
    warm = times[1:]
    return {"steps": len(times), "first_step_ms": times[0] * 1e3,
            "p50_step_ms": statistics.median(warm) * 1e3,
            "p90_step_ms": float(np.percentile(warm, 90)) * 1e3,
            "examples_per_s": len(warm) * rows / sum(warm)}


def phase_training(path: str, enc_dict: dict, score, ckpt_dir: str, device: str = "cuda"):
    """RankTrainer.fit from the serving checkpoint on the fused step, then a
    few standard steps.  Returns (summary, trained trainer, train batches)."""
    t0 = time.perf_counter()
    train_loader = labelled_loader(score, TRAIN_BATCHES, SEED + 4)
    valid_loader = labelled_loader(score, VALID_BATCHES, SEED + 5)
    model = load_model(path, enc_dict, device)
    trainer = RankTrainer(device=device, model_ckpt_dir=ckpt_dir)
    setup_s = time.perf_counter() - t0

    # the main path: every count is 0 just before it and read just after
    reset_launches()
    t0 = time.perf_counter()
    metric, times, losses = timed_fit(trainer, model, train_loader, valid_loader, EPOCHS,
                                      device)
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    steps = EPOCHS * TRAIN_BATCHES
    require_launches(launches, {"embedding_lookup": steps + EPOCHS * VALID_BATCHES,
                                "embedding_grad": 0, "fused_adam": steps}, "fused fit")
    if not trainer._train_step.fused:
        raise RuntimeError("fit did not take the fused step")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not (np.all(np.isfinite(losses)) and last < first):
        raise RuntimeError(f"the training loss did not fall: {losses}")
    files = sorted(os.listdir(ckpt_dir))
    want = {f"model_e_{i}.ckpt" for i in range(1, EPOCHS + 1)} | {"model_best.ckpt"}
    if not want <= set(files):
        raise RuntimeError(f"checkpoints missing: {sorted(want - set(files))} of {files}")

    # the standard step (REC_PANGU_TPU_FUSED_ADAM=0): K1 + K2 + torch.optim.Adam
    std_loader = DataLoader(_Arrays({k: v[:STD_STEPS * BATCH] for k, v in
                                     train_loader.dataset.arrays.items()}), batch_size=BATCH)
    std_model = load_model(path, enc_dict, device)
    std_trainer = RankTrainer(device=device, model_ckpt_dir=ckpt_dir)
    os.environ["REC_PANGU_TPU_FUSED_ADAM"] = "0"
    try:
        reset_launches()
        _, std_times, std_losses = timed_fit(std_trainer, std_model, std_loader, None, 1,
                                             device)
        std_launches = read_launches()
    finally:
        del os.environ["REC_PANGU_TPU_FUSED_ADAM"]
    require_launches(std_launches, {"embedding_lookup": STD_STEPS,
                                    "embedding_grad": STD_STEPS, "fused_adam": 0},
                     "standard-step fit")
    if std_trainer._train_step.fused or not np.all(np.isfinite(std_losses)):
        raise RuntimeError(f"the standard step did not run cleanly: {std_losses}")

    summary = {
        "phase": "training", "model": "DeepFM", "batch": BATCH, "epochs": EPOCHS,
        "steps_per_epoch": TRAIN_BATCHES, "valid_batches": VALID_BATCHES, "lr": LR,
        "table_rows": int(model.embedding.table.shape[0]), "launches": launches,
        "fused": step_stats(times, BATCH), "fit_s": fit_s, "setup_s": setup_s,
        "loss_first3": first, "loss_last3": last, "losses": losses,
        "train_metric": metric, "checkpoints": files,
        "standard_launches": std_launches, "standard": step_stats(std_times, BATCH),
        "standard_losses": std_losses,
    }
    return summary, trainer, train_loader


def phase_card_vs_cpu(path: str, enc_dict: dict, batches, devices=("cuda", "cpu")) -> dict:
    """The first fused steps from the same weights on the card (kernels) and
    on the CPU (plain versions)."""
    runs = {}
    for dev in devices:
        model = load_model(path, enc_dict, dev).train()
        step = maybe_enable_fused_update(model, LR, TRAIN_BATCHES)
        losses = []
        for i, batch in enumerate(batches):
            out = step(model.upload_batch(batch, torch.device(dev), train=True), i)
            losses.append(float(out["loss"].detach()))
            if i == 0:
                after_one = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        runs[dev] = (losses, after_one)
    (card_losses, card), (cpu_losses, cpu) = (runs[d] for d in devices)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    diffs = {k: (card[k] - cpu[k]).abs() for k in cpu}
    table_key = "embedding.table"
    dense_err = max(d.max().item() for k, d in diffs.items() if k != table_key)
    table = diffs[table_key]
    beyond = int((table > TABLE_ATOL).sum().item())
    summary = {"phase": "card_vs_cpu", "steps": len(batches), "card_losses": card_losses,
               "cpu_losses": cpu_losses, "loss_max_rel_diff": loss_rel,
               "dense_max_abs_diff": dense_err, "table_max_abs_diff": table.max().item(),
               "table_elements_beyond_atol": beyond, "table_elements": table.numel(),
               "loss_rtol": LOSS_RTOL, "dense_atol": DENSE_ATOL, "table_atol": TABLE_ATOL,
               "handful": HANDFUL}
    if (loss_rel > LOSS_RTOL or dense_err > DENSE_ATOL or beyond > HANDFUL
            or table.max().item() > 2 * LR):
        raise RuntimeError(f"the card's training differs from the CPU's: {summary}")
    return summary


def profile_ops(prof, calls: int, per: str) -> tuple:
    """(device busy seconds, the largest device items per ``per``).
    Device-side events only (kernels, copies): the CPU ops that launched
    them, and the user annotations around them (``Optimizer.step#...``),
    carry the same device time and would count it twice."""
    ops = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
           if e.self_device_time_total > 0 and not e.is_user_annotation
           and e.device_type != torch.autograd.DeviceType.CPU]
    ops.sort(key=lambda op: -op[1])
    busy_s = sum(op[1] for op in ops) / 1e6
    return busy_s, [{"op": k[:80], f"ms_per_{per}": us / 1e3 / calls, "calls": c}
                    for k, us, c in ops[:12]]


def phase_train_profile(trainer: RankTrainer, batches) -> dict:
    """torch.profiler over fused training steps (the trainer's own step on
    host batches): device time by operation and the card's idle share."""
    from torch.profiler import ProfilerActivity, profile

    trainer.model.train()
    for batch in batches[:2]:  # warm
        trainer._step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            trainer._step(batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    busy_s, ops = profile_ops(prof, len(batches), "step")
    n = len(batches)
    return {"phase": "train_profile", "steps": n, "wall_ms_per_step": wall_s * 1e3 / n,
            "device_busy_ms_per_step": busy_s * 1e3 / n,
            "device_idle_share": 1.0 - busy_s / wall_s, "device_ops": ops}


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

    bandwidth = peak_bandwidth(kind)
    rows = [phase_kernel(bandwidth), phase_table_grad(bandwidth), phase_fused_adam(bandwidth)]
    for row in rows:
        emit({"phase": "kernel", **row})

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "model.ckpt")
        enc_dict = write_checkpoint(path)
        serving, model, score, profiled = phase_serving(path, enc_dict)
        emit(serving)
        emit(phase_profile(model, profiled))
        del model
        training, trainer, train_loader = phase_training(path, enc_dict, score,
                                                         os.path.join(tmp, "ckpt"))
        emit(training)
        batches = [b for _, b in zip(range(TRAIN_PROFILED), train_loader)]
        emit(phase_card_vs_cpu(path, enc_dict, batches[:CPU_STEPS]))
        emit(phase_train_profile(trainer, batches))

    # launches on each kernel's own main path: the lookup's on serving, the
    # fused Adam's on the fused fit, the gradient's on the standard-step fit
    launches = {"embedding_lookup": serving["launches"]["embedding_lookup"],
                "fused_adam": training["launches"]["fused_adam"],
                "embedding_grad": training["standard_launches"]["embedding_grad"]}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: launches[row["name"]] if k == "launches" else row[k] for k in keys}
                      for row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
