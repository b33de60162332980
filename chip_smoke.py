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
               PyTorch library call, and the kernel's bound.  The lookup
               (a gather) is bit-equal; the table gradient and the fused Adam
               sum in another order than the plain version's atomics, within
               the rounding bound stated at ``sum_tolerance``; the fused Adam
               also at the sequence shape with its dense gradient stream and
               bfloat16 moments (``phase_fused_adam_seq``); the table
               gradient again at K7's call-site shape with its sort on the
               card (``phase_sorted_accumulate``); the fused
               encoder (K4f) within the tolerances at ``check_encoder``; its
               backward (K4b) and dropout forward against the plain version's
               autograd with the same dropout masks, within the tolerances at
               ``check_encoder_bwd``, and the masks' seed and keep share.
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
9. seq_checkpoint -- a SASRec checkpoint in the JAX layout at bench.py's
               sequence width (1,000,000 items, D=64, L=50, 2 blocks of 4
               heads, inner 32, gelu), random weights from a seed.
10. seq_serving -- SequenceTrainer.load_model and make_retrieval_scorer:
               requests of 1024 histories, top-200 of the L2-normalized
               corpus (K1 + K4f); latency, users/s, launches per request;
               a few requests held against the same model on the CPU.
11. seq_profile -- host stages of a request (id check, upload, encoder,
               scoring, top-k, copy back) and torch.profiler's device time
               by operation and idle share.
12. seq_eval -- SequenceTrainer.evaluate_model on the bundled MovieLens
               sample (max_length 50), card against CPU.
13. seq_ce  -- the streamed softmax CE's forward and backward at the bench
               shape against F.cross_entropy over the materialized
               [1024, 1,000,000] logits: loss, d_user, item gradient, times.
14. seq_training -- SequenceTrainer.fit on SASRec at full width (dropout 0.1)
               from the checkpoint: 2 epochs of 16 bench-shape batches with
               validation, log.csv, checkpoints and early stopping on the
               sequence fused step (K1 + K4f + K4b + K3 once a step); then a
               few standard steps (K1 + K4f + K4b + K2) and a few fused steps
               with bfloat16 moments.  Step times and examples/s.
15. seq_card_vs_cpu -- the first three sequence fused steps on the card and
               on the CPU (100,000 items, batches of 256, the same dropout).
16. seq_train_profile -- host stages and torch.profiler over a few
               sequence fused steps.
17. iocrec_* -- IOCRec at the same width (K=4, a local and a global
               encoder, the K-max CE): checkpoint, serving, profile, eval,
               training (fit, then standard steps), card_vs_cpu,
               train_profile.
18. contrarec_*, clrec_* -- ContraRec and CLRec (the BERT4Rec encoder) at
               the same width: checkpoint, serving, profile, eval, training
               (fit, 2 epochs on the fused step, with the trainer's host
               views or lookup_all), ContraRec's device_aug (standard steps
               on batches without views: the views are drawn on the card
               and the table gradient is K7's counterpart, once a step),
               card_vs_cpu, train_profile.

Then the kernels line, the card's name and power limit as nvidia-smi gives
them, and last {"ok": true, "device": {...}}.

Float32 matmuls are held to full precision for the comparisons:
torch.backends.cuda.matmul.allow_tf32 = False (and the cuDNN flag too).
"""
import contextlib
import copy
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import rec_pangu_tpu_torch as port
from rec_pangu_tpu_torch.data import DataLoader, get_dataloader
from rec_pangu_tpu_torch.eval.retrieval import l2_normalize
from rec_pangu_tpu_torch.ops.embedding import check_ids, check_item_ids, padded_rows
from rec_pangu_tpu_torch.ops.kernels import _build
from rec_pangu_tpu_torch.ops.kernels import embedding_grad as grad
from rec_pangu_tpu_torch.ops.kernels import embedding_lookup as lookup
from rec_pangu_tpu_torch.ops.kernels import fused_adam as adam
from rec_pangu_tpu_torch.ops.kernels import fused_encoder as encoder
from rec_pangu_tpu_torch.ops.kernels import global_attn as gattn
from rec_pangu_tpu_torch.ops.kernels import multimax_ce as mmce
from rec_pangu_tpu_torch.ops.sequence_enc import TransformerEncoder
from rec_pangu_tpu_torch.serving import make_ranking_scorer, make_retrieval_scorer
from rec_pangu_tpu_torch.serving.scorer import score_items
from rec_pangu_tpu_torch.convert import jax_variables
from rec_pangu_tpu_torch.train import RankTrainer, SequenceTrainer, save_checkpoint
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

# SASRec retrieval at bench.py's sequence shape with SASRec's own defaults
SEQ_VOCAB, SEQ_L, SEQ_DIM, SEQ_BATCH, SEQ_TOPK = 1_000_000, 50, 64, 1024, 200
SEQ_CONFIG = {"embedding_dim": SEQ_DIM, "max_length": SEQ_L, "n_layers": 2, "n_heads": 4,
              "inner_size": 32, "hidden_act": "gelu", "layer_norm_eps": 1e-3,
              "item_col": "item_id"}
SEQ_WARMUP, SEQ_REQUESTS = 3, 200
SEQ_CPU_CHECKS = 2         # requests held against the same model on the CPU
SEQ_PROFILED = 10          # requests traced by the profiler
ENCODER_ATOL = 1e-5        # kernel against plain: query rows with a valid key
MASKED_ROW_ATOL = 5e-2     # ... rows without one (see check_encoder; first run: 0.0092)
USER_EMB_ATOL = 1e-5       # card against CPU: user embeddings
SCORE_ATOL = 1e-5          # ... and the retrieval scores
SEQ_DATA = os.path.join(ROOT, "examples", "sequence_recall", "sample_data")

# data-sheet memory bandwidth (bytes/s) of the cards this targets
_BANDWIDTH = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
              ("H100", 3.35e12))
# data-sheet float32 rate outside the tensor cores (FLOP/s)
_FP32_PEAK = (("H100 PCIe", 51e12), ("H100 NVL", 60e12), ("H200", 67e12), ("H100", 67e12))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _lookup_rate(table, name: str, what: str) -> float:
    for key, rate in table:
        if key in name:
            return rate
    raise RuntimeError(f"no data-sheet {what} known for {name!r}")


def peak_bandwidth(name: str) -> float:
    return _lookup_rate(_BANDWIDTH, name, "bandwidth")


def peak_fp32(name: str) -> float:
    return _lookup_rate(_FP32_PEAK, name, "float32 rate")


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


def check_adam_step(ids, rows, state, hyper, what: str, dense=None) -> float:
    """One K3 step from ``state`` against the plain version from the same
    state; run twice for the same bits.  Rows hit at most once sum the same
    terms in the same order: bit-equal.  Rows hit more often: the moments
    within the gradient's sum bound (scaled by 1-b1, resp. 2|g|(1-b2)) plus
    two ulps, the table within 2*lr (a gradient within rounding of zero may
    change sign, and Adam's step is lr*m_hat/(sqrt(v_hat)+eps)).  With
    bfloat16 moments the moments also within one bfloat16 ulp (2^-8
    relative) of their rounding.  ``dense``: K3's dense gradient stream.
    Returns the largest difference over p, m and v."""
    lr, b1, b2 = (float(x) for x in hyper[:3])
    num_rows = state[0].shape[0]
    outs = []
    for _ in range(2):
        p, m, v = (t.clone() for t in state)
        adam.planned_adam_update(ids, rows, p, m, v, hyper, dense)
        outs.append((p, m, v))
    for a, b in zip(*outs):
        require_equal(a, b, f"{what}, run twice")
    ref = [t.clone() for t in state]
    adam.planned_adam_update_reference(ids, rows, *ref, hyper, dense)
    g_bound, hits = sum_tolerance(ids, rows, num_rows)
    once = (hits <= 1)[:, None]
    g = grad.table_grad_reference(ids, rows, num_rows)
    if dense is not None:
        g = g + dense
    g = g.abs()
    ulp = 2 ** -7 if state[1].dtype == torch.bfloat16 else 2 ** -22
    bounds = (torch.full_like(g, 2 * lr),
              (1 - b1) * g_bound + ulp * ref[1].float().abs(),
              (1 - b2) * (2 * g + g_bound) * g_bound + ulp * ref[2].float().abs())
    err = 0.0
    for name, got, want, bound in zip("pmv", outs[0], ref, bounds):
        err = max(err, require_within(got.float(), want.float(), torch.where(once, 0.0, bound),
                                      f"{what}: {name}"))
    return err


def phase_fused_adam_seq(bandwidth: float) -> dict:
    """K3 at the sequence shape (the SASRec table, 1024 histories of 50),
    with the dense gradient stream, f32 and bfloat16 moments, uniform and
    skewed ids, against the plain version; times and byte bounds."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    num_rows, n = padded_rows(SEQ_VOCAB), SEQ_BATCH * SEQ_L
    hist = [torch.randint(0, SEQ_VOCAB, (n,), generator=gen, device="cuda", dtype=torch.int32)
            for _ in range(ID_SETS)]
    rng = np.random.default_rng(SEED + 31)
    skewed = {"all_equal": torch.full((n,), SEQ_VOCAB // 2, dtype=torch.int32, device="cuda"),
              "zipf": torch.from_numpy(np.minimum(rng.zipf(ZIPF_A, n), SEQ_VOCAB - 1)
                                       .astype(np.int32)).cuda()}
    cot = torch.randn(n, SEQ_DIM, generator=gen, device="cuda") * 1e-3
    dense = torch.randn(num_rows, SEQ_DIM, generator=gen, device="cuda") * 1e-6
    hyper = adam.adam_hyper(2, LR)
    out, max_abs_err = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        key = "f32" if dtype == torch.float32 else "bf16"
        p, m, v = adam_state(num_rows, SEQ_DIM, gen)
        m, v = m.to(dtype), v.to(dtype)
        state = (p, m, v)
        max_abs_err = max(max_abs_err, check_adam_step(hist[0], cot, state, hyper,
                                                       f"sequence shape, dense, {key}", dense))
        for kind, x in skewed.items():
            max_abs_err = max(max_abs_err, check_adam_step(
                x, cot, state, hyper, f"sequence shape, dense, {key}, {kind}", dense))
        elem = 4 + 4 + 2 * 2 * m.element_size()  # p read and written, m and v too
        moved = num_rows * SEQ_DIM * (elem + 4) + n * SEQ_DIM * 4 + n * 4  # + dense, rows, ids
        out[key] = {
            "ms": median_ms([lambda x=x: adam.planned_adam_update(x, cot, p, m, v, hyper, dense)
                             for x in hist]),
            "plain_ms": median_ms([lambda x=x: adam.planned_adam_update_reference(
                x, cot, p, m, v, hyper, dense) for x in hist]),
            "bytes": moved, "bound_ms": moved / bandwidth * 1e3,
            "skewed_ms": {kind: median_ms([lambda x=x: adam.planned_adam_update(
                x, cot, p, m, v, hyper, dense)], SKEW_LAUNCHES) for kind, x in skewed.items()},
        }
        del p, m, v, state
    return {"table_rows": num_rows, "ids": n, "dim": SEQ_DIM, "max_abs_err": max_abs_err, **out}


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

    seq = phase_fused_adam_seq(bandwidth)
    return {
        "name": "fused_adam", "route": "cuda",
        "source": "rec_pangu_tpu_torch/csrc/fused_adam.cu",
        "replaces": "rec_pangu_tpu/ops/kernels/fused_adam.py:54",
        "max_abs_err": max(max_abs_err, seq["max_abs_err"]),
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
        "sequence_shape": seq,
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
                                "fused_adam": 0, "fused_encoder": 0}, "serving")

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


# each kernel's launch count: (module, attribute)
COUNTERS = {"embedding_lookup": (lookup, "LAUNCHES"), "embedding_grad": (grad, "LAUNCHES"),
            "fused_adam": (adam, "LAUNCHES"), "fused_encoder": (encoder, "LAUNCHES"),
            "fused_encoder_bwd": (encoder, "BACKWARD_LAUNCHES"),
            "global_attn": (gattn, "LAUNCHES"), "global_attn_bwd": (gattn, "BACKWARD_LAUNCHES"),
            "multimax_ce": (mmce, "LAUNCHES"), "multimax_ce_bwd": (mmce, "BACKWARD_LAUNCHES")}


def reset_launches() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_launches() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def require_launches(got: dict, want: dict, what: str) -> None:
    """Every count as ``want`` gives it, 0 where it gives none."""
    if any(got[k] != want.get(k, 0) for k in got):
        raise RuntimeError(f"{what}: kernel launches {got}, expected {want} (0 elsewhere)")


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
                                "embedding_grad": 0, "fused_adam": steps,
                                "fused_encoder": 0}, "fused fit")
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
                                    "embedding_grad": STD_STEPS, "fused_adam": 0,
                                    "fused_encoder": 0}, "standard-step fit")
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


# ----------------------------------------------------------------- sequence
def random_encoder(dim: int, heads: int, inner: int, layers: int, act: str, seed: int,
                   dev, eps: float = SEQ_CONFIG["layer_norm_eps"]) -> TransformerEncoder:
    """A TransformerEncoder with seeded random weights: the JAX package's
    init, plus small random biases and LayerNorm terms so that every term
    of a block counts."""
    gen = torch.Generator().manual_seed(seed)
    enc = TransformerEncoder(dim, layers, heads, inner, 0.0, 0.0, act, eps, gen)
    with torch.no_grad():
        for p in enc.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return enc.to(dev).eval()


def prefix_masks(n: int, length: int, gen, min_len: int = 0) -> torch.Tensor:
    """[n, length] float32 masks of histories whose lengths are uniform in
    [min_len, length]: valid items first, then padding."""
    lengths = torch.randint(min_len, length + 1, (n,), generator=gen, device=gen.device)
    return (torch.arange(length, device=gen.device)[None] < lengths[:, None]).float()


def density_masks(n: int, length: int, gen) -> torch.Tensor:
    """bench.py's sequence masks: each position valid with probability 0.9."""
    return (torch.rand(n, length, generator=gen, device=gen.device) < 0.9).float()


def rows_with_key(key_valid: torch.Tensor, causal: bool) -> torch.Tensor:
    """[N, L] bool: query l of sample n may see at least one valid key."""
    ok = key_valid != 0
    if causal:
        return ok.cumsum(dim=1) > 0
    return ok.any(dim=1, keepdim=True).expand_as(ok)


def check_encoder(x, key_valid, enc: TransformerEncoder, causal: bool, what: str) -> dict:
    """K4f against its plain version on the same inputs, run twice for the
    same bits.  Rows with a valid key within ENCODER_ATOL.  A row without
    one scores every key s - 1e6, which float32 rounds to a multiple of
    1/16: two sums of s that differ in their last bit can round to
    neighbouring multiples and move one key's weight by e^(1/16), so those
    rows are held within MASKED_ROW_ATOL (a masking fault, such as a
    skipped key or a -inf, moves them by order 1 or makes them NaN)."""
    with torch.no_grad():
        packed = enc.packed()
        args = (x, key_valid, packed, enc.n_heads, causal, enc.hidden_act, enc.layer_norm_eps)
        y = encoder.fused_encoder(*args)
        require_equal(encoder.fused_encoder(*args), y, f"{what}, run twice")
        ref = encoder.fused_encoder_reference(*args)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"{what}: non-finite encoder output")
    err = (y - ref).abs().amax(dim=-1)
    has = rows_with_key(key_valid, causal)
    out = {"case": what, "max_abs_err": err.max().item(),
           "rows_with_key_err": err[has].max().item() if bool(has.any()) else 0.0,
           "rows_without_key": int((~has).sum().item()),
           "rows_without_key_err": err[~has].max().item() if bool((~has).any()) else 0.0}
    if out["rows_with_key_err"] > ENCODER_ATOL or out["rows_without_key_err"] > MASKED_ROW_ATOL:
        raise RuntimeError(f"{what}: kernel differs from its plain version: {out}")
    return out


def library_encoder(enc: TransformerEncoder) -> torch.nn.TransformerEncoder:
    """torch.nn.TransformerEncoder (post-LN, batch_first, tanh-gelu, dropout
    0, the same eps) holding ``enc``'s weights."""
    first = enc.blocks[0]
    dim, inner = first.query.weight.shape[0], first.ffn_1.weight.shape[0]
    layer = torch.nn.TransformerEncoderLayer(
        dim, enc.n_heads, dim_feedforward=inner, dropout=0.0,
        activation=lambda h: torch.nn.functional.gelu(h, approximate="tanh"),
        layer_norm_eps=enc.layer_norm_eps, batch_first=True, norm_first=False)
    lib = torch.nn.TransformerEncoder(layer, len(enc.blocks), enable_nested_tensor=False)
    lib = lib.to(first.query.weight.device).eval()
    with torch.no_grad():
        for blk, lay in zip(enc.blocks, lib.layers):
            attn = lay.self_attn
            attn.in_proj_weight.copy_(torch.cat([blk.query.weight, blk.key.weight,
                                                 blk.value.weight]))
            attn.in_proj_bias.copy_(torch.cat([blk.query.bias, blk.key.bias, blk.value.bias]))
            for dst, src in ((attn.out_proj, blk.dense), (lay.linear1, blk.ffn_1),
                             (lay.linear2, blk.ffn_2), (lay.norm1, blk.LayerNorm_0),
                             (lay.norm2, blk.LayerNorm_1)):
                dst.weight.copy_(src.weight)
                dst.bias.copy_(src.bias)
    return lib


def encoder_work(n: int, length: int, dim: int, inner: int, layers: int, packed) -> tuple:
    """(flop, bytes) the encoder function needs: every product of the
    projections, the full L x L scores and the probabilities times v, as
    the function defines them; x read and y written once, the mask and the
    weights read once."""
    flop = 2 * n * length * layers * (4 * dim * dim + 2 * dim * inner + 2 * length * dim)
    moved = 2 * n * length * dim * 4 + n * length * 4 + sum(t.numel() * 4 for t in packed)
    return flop, moved


def phase_fused_encoder(bandwidth: float, fp32: float) -> dict:
    """K4f against its plain version at the bench shape (prefix masks with
    empty histories, bench.py's 0.9-density masks) and at edge shapes; times
    of the kernel, the plain version and torch.nn.TransformerEncoder."""
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    heads, inner, layers = SEQ_CONFIG["n_heads"], SEQ_CONFIG["inner_size"], SEQ_CONFIG["n_layers"]

    def x_of(n, length, dim):  # embedding-sized rows, as the item table holds
        return torch.randn(n, length, dim, generator=gen, device=dev) * math.sqrt(2.0 / dim)

    enc = random_encoder(SEQ_DIM, heads, inner, layers, "gelu", SEED + 40, dev)
    x = x_of(SEQ_BATCH, SEQ_L, SEQ_DIM)
    masks = {"prefix": prefix_masks(SEQ_BATCH, SEQ_L, gen),
             "density_0.9": density_masks(SEQ_BATCH, SEQ_L, gen)}
    cases = [check_encoder(x, kv, enc, True, f"bench shape, {kind} masks")
             for kind, kv in masks.items()]
    for n in (1, 3, 1027):
        cases.append(check_encoder(x_of(n, SEQ_L, SEQ_DIM), prefix_masks(n, SEQ_L, gen), enc,
                                   True, f"N={n}"))
    for length in (1, 20):
        cases.append(check_encoder(x_of(64, length, SEQ_DIM), prefix_masks(64, length, gen),
                                   enc, True, f"L={length}"))
    for dim, n_heads, act, causal in ((32, 2, "gelu", True), (SEQ_DIM, heads, "relu", True),
                                      (SEQ_DIM, heads, "swish", True),
                                      (SEQ_DIM, heads, "gelu", False)):
        e = random_encoder(dim, n_heads, inner, layers, act, SEED + 42, dev)
        cases.append(check_encoder(x_of(256, SEQ_L, dim), prefix_masks(256, SEQ_L, gen), e,
                                   causal, f"D={dim} heads={n_heads} {act} causal={causal}"))

    kv = masks["prefix"]
    eps = enc.layer_norm_eps
    with torch.no_grad():
        packed = enc.packed()
        lib = library_encoder(enc)
        lib_mask = encoder.additive_mask(kv, True)[:, 0].repeat_interleave(heads, dim=0)
        y = encoder.fused_encoder(x, kv, packed, heads, True, "gelu", eps)
        lib_y = lib(x, mask=lib_mask)
        has = rows_with_key(kv, True)
        lib_err = (lib_y - y).abs().amax(dim=-1)[has].max().item()
        if lib_err > ENCODER_ATOL:
            raise RuntimeError(f"torch.nn.TransformerEncoder differs from the kernel by "
                               f"{lib_err} on rows with a valid key")
        ms = median_ms([lambda: encoder.fused_encoder(x, kv, packed, heads, True, "gelu", eps)])
        plain_ms = median_ms([lambda: encoder.fused_encoder_reference(
            x, kv, packed, heads, True, "gelu", eps)])
        library_ms = median_ms([lambda: lib(x, mask=lib_mask)])
        call = call_ms(lambda: encoder.fused_encoder(x, kv, packed, heads, True, "gelu", eps))
    flop, moved = encoder_work(SEQ_BATCH, SEQ_L, SEQ_DIM, inner, layers, packed)
    by_ops, by_bytes = flop / fp32 * 1e3, moved / bandwidth * 1e3
    return {
        "name": "fused_encoder", "route": "cuda",
        "source": "rec_pangu_tpu_torch/csrc/fused_encoder.cu",
        "replaces": "rec_pangu_tpu/ops/kernels/fused_encoder.py:175",
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": f"rows with a valid key atol {ENCODER_ATOL}, rows without one atol "
                     f"{MASKED_ROW_ATOL} (s - 1e6 rounds to multiples of 1/16)",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(by_ops, by_bytes),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": library_ms,
        "library": "torch.nn.TransformerEncoder (post-LN, batch_first, tanh gelu, "
                   "additive float mask [N*H, L, L])",
        "library_max_abs_err_rows_with_key": lib_err, "call_ms": call,
        "flop": flop, "bytes": moved, "ops_bound_ms": by_ops, "bytes_bound_ms": by_bytes,
        "shape": {"N": SEQ_BATCH, "L": SEQ_L, "D": SEQ_DIM, "heads": heads, "inner": inner,
                  "layers": layers, "act": "gelu", "causal": True, "masks": "prefix"},
        "cases": cases, "seconds": time.perf_counter() - t_start,
    }


BWD_REL_TOL = 1e-5         # K4b against plain autograd, dy on rows with a valid key
                           # (first run: 1.7e-6)
MASKED_BWD_REL_TOL = 5e-2  # ... dy on every row (see check_encoder_bwd)
DROP = 0.1                 # SASRec's hidden and attention dropout
KINK_ROUNDINGS = 1         # relu: |pre-activation| within this many roundings of 0
                           # (seen: the samples apart lay within 0.085 of them)
BWD_LAUNCHES = 20          # backward calls a timing graph holds


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the largest |want| (at least 1e-30): gradients
    are sums of many terms, so their rounding scales with the array."""
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def encoder_grads(x, kv, packed, dy, heads, causal, act, eps, rate, seed, plain=False):
    """(y, dx, the 8 packed gradients) of one forward and backward, through
    the kernels (K4f in training mode, K4b) or the plain version's autograd."""
    xs = x.detach().clone().requires_grad_()
    ps = [t.detach().clone().requires_grad_() for t in packed]
    fn = encoder.fused_encoder_reference if plain else encoder.fused_encoder
    y = fn(xs, kv, ps, heads, causal, act, eps, True, rate, rate, seed)
    grads = torch.autograd.grad(y, [xs] + ps, dy)
    return y.detach(), grads[0], grads[1:]


def check_encoder_bwd(x, kv, enc: TransformerEncoder, causal: bool, what: str,
                      rate: float = DROP, seed: int = 7) -> dict:
    """K4b (and K4f in training mode) against the plain version's autograd
    on the same inputs and dropout masks, run twice for the same bits.  With
    dy zero on the query rows that see no valid key, no value depends on
    such a row (a valid query gives an invalid key weight exp(-1e6) = 0), so
    dx and the 8 gradients are held within BWD_REL_TOL of each array's
    largest entry.  With dy on every row, such rows' probabilities (scores
    s - 1e6 round to multiples of 1/16, see check_encoder) reach every
    gradient, which are held within MASKED_BWD_REL_TOL."""
    heads, act, eps = enc.n_heads, enc.hidden_act, enc.layer_norm_eps
    packed = [t.detach() for t in enc.packed()]
    has = rows_with_key(kv, causal)
    gen = torch.Generator(device=x.device).manual_seed(seed + 1)
    dy_all = torch.randn(x.shape, generator=gen, device=x.device)
    out = {"case": what, "dropout": rate}
    for name, dy in (("key_rows", dy_all * has[..., None]), ("all_rows", dy_all)):
        y, dx, grads = encoder_grads(x, kv, packed, dy, heads, causal, act, eps, rate, seed)
        y2, dx2, grads2 = encoder_grads(x, kv, packed, dy, heads, causal, act, eps, rate, seed)
        for a, b, part in zip((y, dx) + grads, (y2, dx2) + grads2,
                              ("y", "dx") + encoder.PACKED_NAMES):
            require_equal(a, b, f"{what}, {part}, run twice")
        ref_y, ref_dx, ref_grads = encoder_grads(x, kv, packed, dy, heads, causal, act, eps, rate,
                                                 seed, plain=True)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in (y, dx) + grads):
            raise RuntimeError(f"{what}: non-finite encoder output or gradient")
        errs = {"dx": rel_err(dx, ref_dx)}
        errs.update({n: rel_err(g, r) for n, g, r in zip(encoder.PACKED_NAMES, grads, ref_grads)})
        out[name] = errs
        limit = BWD_REL_TOL if name == "key_rows" else MASKED_BWD_REL_TOL
        if max(errs.values()) > limit:
            raise RuntimeError(f"{what}: K4b differs from plain autograd ({name}): {errs}")
        if name == "key_rows":
            err = (y - ref_y).abs().amax(dim=-1)
            out["y_rows_with_key_err"] = err[has].max().item() if bool(has.any()) else 0.0
            if out["y_rows_with_key_err"] > ENCODER_ATOL:
                raise RuntimeError(f"{what}: the training forward differs from the plain "
                                   f"version: {out}")
    out["max_rel_err"] = max(max(out[k].values()) for k in ("key_rows", "all_rows"))
    return out


def ffn_preactivations(x, kv, packed, heads, causal, act, eps, rate, seed, dtype) -> list:
    """Each layer's FFN pre-activations [N, L, inner] in the plain forward
    at ``dtype``, with the kernels' dropout masks (recorded where the plain
    version applies its activation)."""
    seen = []
    activate = encoder._activate

    def record(h, name):
        seen.append(h)
        return activate(h, name)

    encoder._activate = record
    try:
        with torch.no_grad():
            encoder.fused_encoder_reference(x.to(dtype), kv, [t.to(dtype) for t in packed],
                                            heads, causal, act, eps, True, rate, rate, seed)
    finally:
        encoder._activate = activate
    return seen


def check_encoder_bwd_relu(x, kv, enc: TransformerEncoder, what: str, rate: float,
                           seed: int = 7) -> dict:
    """K4b and K4f's dropout forward against the plain version's autograd
    with relu, causal, every key valid.  Relu's derivative is 1 on one side
    of 0 and 0 on the other, so where a pre-activation lies within rounding
    of 0 the kernel and the plain version may take different sides and that
    sample's gradients differ beyond rounding.  Such samples are found from
    the plain forward in float64: layer l's float32 rounding is R_l =
    max |h32 - h64| over its pre-activations, and a sample with any |h64| <=
    KINK_ROUNDINGS * R_l is a kink sample.  With dy on every sample, each
    sample whose dx lies apart beyond BWD_REL_TOL must be a kink sample.
    Then dy is zero on those (samples are independent, so they add nothing
    to any gradient); y, dx and the 8 gradients are held within
    BWD_REL_TOL of each array's largest entry, each run twice for the same
    bits."""
    heads, act, eps = enc.n_heads, enc.hidden_act, enc.layer_norm_eps
    packed = [t.detach() for t in enc.packed()]
    args = (x, kv, packed, heads, True, act, eps, rate, seed)
    h64 = ffn_preactivations(*args, torch.float64)
    rounding = [(a.double() - b).abs().max().item()
                for a, b in zip(ffn_preactivations(*args, torch.float32), h64)]
    # each sample's pre-activation nearest 0, in roundings of its layer
    nearest = torch.stack([(h.abs() / r).flatten(1).amin(1)
                           for h, r in zip(h64, rounding)]).amin(0)
    kinked = nearest <= KINK_ROUNDINGS
    del h64
    gen = torch.Generator(device=x.device).manual_seed(seed + 1)
    dy = torch.randn(x.shape, generator=gen, device=x.device)
    _, dx, _ = encoder_grads(x, kv, packed, dy, heads, True, act, eps, rate, seed)
    _, ref_dx, _ = encoder_grads(x, kv, packed, dy, heads, True, act, eps, rate, seed,
                                 plain=True)
    apart = ((dx - ref_dx).abs().flatten(1).amax(1) / ref_dx.abs().max()) > BWD_REL_TOL
    apart_nearest = sorted(nearest[apart].tolist())
    if bool((apart & ~kinked).any()):
        raise RuntimeError(f"{what}: samples apart beyond {BWD_REL_TOL} whose pre-activations "
                           f"lie farther than {KINK_ROUNDINGS} roundings from 0: "
                           f"{apart_nearest}")
    dy = dy * (~kinked)[:, None, None]
    grad_args = (x, kv, packed, dy, heads, True, act, eps, rate, seed)
    y, dx, grads = encoder_grads(*grad_args)
    y2, dx2, grads2 = encoder_grads(*grad_args)
    for a, b, part in zip((y, dx) + grads, (y2, dx2) + grads2, ("y", "dx") + encoder.PACKED_NAMES):
        require_equal(a, b, f"{what}, {part}, run twice")
    del y2, dx2, grads2
    ref_y, ref_dx, ref_grads = encoder_grads(*grad_args, plain=True)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for t in (y, dx) + grads):
        raise RuntimeError(f"{what}: non-finite encoder output or gradient")
    errs = {"y": rel_err(y, ref_y), "dx": rel_err(dx, ref_dx)}
    errs.update({n: rel_err(g, r) for n, g, r in zip(encoder.PACKED_NAMES, grads, ref_grads)})
    out = {"case": what, "dropout": rate, "act": act, "samples": x.shape[0],
           "kink_samples": int(kinked.sum()), "preactivation_rounding": rounding,
           "kink_roundings": KINK_ROUNDINGS, "samples_apart_with_dy_everywhere": len(apart_nearest),
           "their_nearest_preactivation_in_roundings": apart_nearest, "other_samples": errs,
           "max_rel_err": max(errs.values())}
    if out["max_rel_err"] > BWD_REL_TOL:
        raise RuntimeError(f"{what}: K4b differs from plain autograd: {out}")
    return out


def phase_fused_encoder_bwd(bandwidth: float, fp32: float) -> dict:
    """K4b (and K4f's dropout forward) against the plain version's autograd
    at the bench shape (prefix masks with empty histories, bench.py's
    0.9-density masks), dropout 0 and 0.1 from one seed, at edge shapes and
    at IOCRec's (3072 views; gelu, and relu with dropout 0.5);
    the dropout masks' seed dependence and keep share; times of the kernel's
    backward, the plain backward and torch.nn.TransformerEncoder's."""
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    heads, inner, layers = SEQ_CONFIG["n_heads"], SEQ_CONFIG["inner_size"], SEQ_CONFIG["n_layers"]

    def x_of(n, length, dim):
        return torch.randn(n, length, dim, generator=gen, device=dev) * math.sqrt(2.0 / dim)

    enc = random_encoder(SEQ_DIM, heads, inner, layers, "gelu", SEED + 44, dev)
    x = x_of(SEQ_BATCH, SEQ_L, SEQ_DIM)
    masks = {"prefix": prefix_masks(SEQ_BATCH, SEQ_L, gen),
             "density_0.9": density_masks(SEQ_BATCH, SEQ_L, gen)}
    cases = [check_encoder_bwd(x, kv, enc, True, f"bench shape, {kind} masks, dropout {rate}",
                               rate)
             for kind, kv in masks.items() for rate in (0.0, DROP)]
    for n in (1, 3, 1027):
        cases.append(check_encoder_bwd(x_of(n, SEQ_L, SEQ_DIM), prefix_masks(n, SEQ_L, gen),
                                       enc, True, f"N={n}"))
    for length in (1, 20):
        cases.append(check_encoder_bwd(x_of(64, length, SEQ_DIM),
                                       prefix_masks(64, length, gen), enc, True, f"L={length}"))
    for dim, n_heads, act, causal in ((32, 2, "gelu", True), (SEQ_DIM, heads, "relu", True),
                                      (SEQ_DIM, heads, "swish", True),
                                      (SEQ_DIM, heads, "gelu", False)):
        e = random_encoder(dim, n_heads, inner, layers, act, SEED + 45, dev)
        cases.append(check_encoder_bwd(x_of(256, SEQ_L, dim), prefix_masks(256, SEQ_L, gen), e,
                                       causal, f"D={dim} heads={n_heads} {act} causal={causal}"))
    # the widest shape: its backward arena exceeds shared memory and lies in
    # device memory instead
    e = random_encoder(128, heads, 512, layers, "gelu", SEED + 46, dev)
    cases.append(check_encoder_bwd(x_of(64, 64, 128), prefix_masks(64, 64, gen), e, True,
                                   "D=128 inner=512 L=64 (arena in device memory)"))
    # IOCRec's local encoder: 3 layers of 2 heads, inner 128, 3072 views, every
    # key valid (its arena lies in device memory at this N); gelu without
    # dropout, and IOCRec's own relu, eps 1e-12 and dropout 0.5
    ioc_shape = (IOC_VIEWS, SEQ_L, SEQ_DIM)
    x_ioc, kv_ioc = x_of(*ioc_shape), torch.ones(IOC_VIEWS, SEQ_L, device=dev)
    e = random_encoder(SEQ_DIM, 2, 128, 3, "gelu", SEED + 47, dev)
    cases.append(check_encoder_bwd(x_ioc, kv_ioc, e, True, "IOCRec shape: 3072 x 50 x 64, "
                                   "3 layers of 2 heads, inner 128", 0.0))
    e = random_encoder(SEQ_DIM, 2, 128, 3, "relu", SEED + 47, dev, IOC_CONFIG["layer_norm_eps"])
    cases.append(check_encoder_bwd_relu(x_ioc, kv_ioc, e, "IOCRec shape, relu, eps 1e-12, "
                                        f"dropout {IOC_DROP}", IOC_DROP))

    # the masks: another seed changes them; the keep share at the bench shape
    kv = masks["prefix"]
    packed = [t.detach() for t in enc.packed()]
    eps = enc.layer_norm_eps
    with torch.no_grad():
        args = (x, kv, packed, heads, True, "gelu", eps, True, DROP, DROP)
        seed_changes = not torch.equal(encoder.fused_encoder(*args, 7),
                                       encoder.fused_encoder(*args, 8))
    kept = sum(float((encoder.dropout_scale(7, SEQ_BATCH, li, site, shape, DROP, dev) > 0)
                     .float().sum())
               for li in range(layers)
               for site, shape in ((encoder.ATTN_SITE, (heads, SEQ_L, SEQ_L)),
                                   (encoder.ATTN_OUT_SITE, (SEQ_L, SEQ_DIM)),
                                   (encoder.FFN_OUT_SITE, (SEQ_L, SEQ_DIM))))
    drawn = SEQ_BATCH * layers * (heads * SEQ_L * SEQ_L + 2 * SEQ_L * SEQ_DIM)
    keep_share = kept / drawn
    if not seed_changes or abs(keep_share - (1 - DROP)) > 1e-3:
        raise RuntimeError(f"dropout masks: another seed changes them {seed_changes}, keep "
                           f"share {keep_share}")

    # times at the bench shape: the backward alone, from the saved forward
    dy = torch.randn(x.shape, generator=gen, device=dev)
    opts = (heads, True, "gelu", eps)

    def backward_calls(rate):
        _, saved = encoder.launch_train(x, kv, packed, *opts, rate, rate, 7, save=True)
        return [lambda: encoder.launch_backward(saved, kv, dy, packed, *opts, rate, rate, 7)]

    def fwd_bwd(fn, params):
        def call():
            xs = x.detach().requires_grad_()
            torch.autograd.grad(fn(xs), [xs] + params, dy)
        return [call]

    def forward(fn):
        def call():
            with torch.no_grad():
                fn(x)
        return [call]

    grad_packed = [t.detach().clone().requires_grad_() for t in packed]
    kernel = lambda xs: encoder.fused_encoder(xs, kv, grad_packed, *opts, True, DROP, DROP, 7)  # noqa: E731,E501
    plain = lambda xs: encoder.fused_encoder_reference(xs, kv, grad_packed, *opts, True,  # noqa: E731
                                                       DROP, DROP, 7)
    lib = library_encoder(enc).train()
    lib_mask = encoder.additive_mask(kv, True)[:, 0].repeat_interleave(heads, dim=0)
    library = lambda xs: lib(xs, mask=lib_mask)  # noqa: E731
    lib_params = list(lib.parameters())

    # autograd's backward runs where its forward ran, so the plain version's
    # and the library's backward are timed as forward+backward minus forward
    times = {
        "ms": median_ms(backward_calls(DROP), BWD_LAUNCHES),
        "ms_no_dropout": median_ms(backward_calls(0.0), BWD_LAUNCHES),
        "forward_ms": median_ms([lambda: encoder.launch_train(x, kv, packed, *opts, DROP, DROP,
                                                              7, save=True)]),
        "fwd_bwd_ms": median_ms(fwd_bwd(kernel, grad_packed), BWD_LAUNCHES),
        "plain_fwd_bwd_ms": median_ms(fwd_bwd(plain, grad_packed), BWD_LAUNCHES),
        "plain_forward_ms": median_ms(forward(plain), BWD_LAUNCHES),
        "library_fwd_bwd_ms": median_ms(fwd_bwd(library, lib_params), BWD_LAUNCHES),
        "library_forward_ms": median_ms(forward(library), BWD_LAUNCHES),
    }
    times["plain_ms"] = times["plain_fwd_bwd_ms"] - times["plain_forward_ms"]
    times["library_ms"] = times["library_fwd_bwd_ms"] - times["library_forward_ms"]
    # at IOCRec's shape and rates (relu, eps 1e-12, dropout 0.5)
    e = random_encoder(SEQ_DIM, 2, 128, 3, "relu", SEED + 47, dev)
    packed_ioc = [t.detach() for t in e.packed()]
    ioc_opts = (2, True, "relu", 1e-12, IOC_DROP, IOC_DROP, 7)
    _, saved_ioc = encoder.launch_train(x_ioc, kv_ioc, packed_ioc, *ioc_opts, save=True)
    dy_ioc = torch.randn(ioc_shape, generator=gen, device=dev)
    times["iocrec_shape_ms"] = median_ms(
        [lambda: encoder.launch_backward(saved_ioc, kv_ioc, dy_ioc, packed_ioc, *ioc_opts)], 5, 5)
    times["iocrec_shape_forward_ms"] = median_ms(
        [lambda: encoder.launch_train(x_ioc, kv_ioc, packed_ioc, *ioc_opts, save=True)], 5, 5)
    ioc_flop, _ = encoder_work(*ioc_shape, 128, 3, packed_ioc)
    times["iocrec_shape_bound_ms"] = 3 * ioc_flop / fp32 * 1e3
    del saved_ioc, dy_ioc
    flop, moved = encoder_work(SEQ_BATCH, SEQ_L, SEQ_DIM, inner, layers, packed)
    flop *= 3  # the recomputed forward, then the weight and the input gradients
    n_el = SEQ_BATCH * SEQ_L * SEQ_DIM
    # each layer's saved input, dy and the mask read; dx and the gradients written
    moved = (layers + 2) * n_el * 4 + SEQ_BATCH * SEQ_L * 4 + 2 * sum(t.numel() * 4
                                                                      for t in packed)
    by_ops, by_bytes = flop / fp32 * 1e3, moved / bandwidth * 1e3
    return {
        "name": "fused_encoder_bwd", "route": "cuda",
        "source": "rec_pangu_tpu_torch/csrc/fused_encoder.cu",
        "replaces": "rec_pangu_tpu/ops/kernels/fused_encoder.py:205",
        "max_abs_err": max(c["max_rel_err"] for c in cases),
        "tolerance": f"dx and each gradient within {BWD_REL_TOL} of the array's largest entry "
                     f"(dy on rows with a valid key), {MASKED_BWD_REL_TOL} (dy on every row); "
                     f"with relu, y too, dy zero on the samples with a pre-activation within "
                     f"{KINK_ROUNDINGS} roundings of 0; max_abs_err is that relative error",
        **times, "bound_ms": max(by_ops, by_bytes),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library": "torch.nn.TransformerEncoder backward, dropout 0 (ms: K4b alone; "
                   "plain_ms and library_ms: forward+backward minus forward)",
        "flop": flop, "bytes": moved, "ops_bound_ms": by_ops, "bytes_bound_ms": by_bytes,
        "keep_share": keep_share, "masks_drawn": drawn, "seed_changes_masks": seed_changes,
        "shape": {"N": SEQ_BATCH, "L": SEQ_L, "D": SEQ_DIM, "heads": heads, "inner": inner,
                  "layers": layers, "act": "gelu", "causal": True, "masks": "prefix",
                  "dropout": DROP},
        "cases": cases, "seconds": time.perf_counter() - t_start,
    }


CE_RTOL = 1e-4             # streamed CE against F.cross_entropy: the loss
CE_GRAD_REL_TOL = 1e-4     # ... d_user and the item gradient, of each array's largest entry
CE_CHUNK_SWEEP = (32_768, 65_536, 262_144)  # timed beside CHUNK_V


def phase_seq_ce(fp32: float) -> dict:
    """The streamed softmax CE (ops/softmax_ce.py) forward and backward at
    the bench shape, against F.cross_entropy over the materialized
    [1024, 1,000,000] logits of the same corpus (row 0 zeroed, the pad rows
    left out): the loss, d_user and the item gradient; times of both."""
    from rec_pangu_tpu_torch.ops import softmax_ce as ce

    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    rows = padded_rows(SEQ_VOCAB)
    table = torch.randn(rows, SEQ_DIM, generator=gen, device="cuda") * math.sqrt(2.0 / SEQ_DIM)
    user = torch.randn(SEQ_BATCH, SEQ_DIM, generator=gen, device="cuda") * 0.5
    pos = torch.randint(1, SEQ_VOCAB, (SEQ_BATCH,), generator=gen, device="cuda")
    keep = (torch.arange(SEQ_VOCAB, device="cuda") != 0)[:, None]

    def streamed(chunk=None):
        u = user.detach().requires_grad_()
        t = table.detach().requires_grad_()
        loss = ce.fused_softmax_ce_padded(u, t, pos, SEQ_VOCAB, chunk=chunk)
        return (loss,) + torch.autograd.grad(loss, [u, t])

    def library():
        u = user.detach().requires_grad_()
        t = table.detach().requires_grad_()
        logits = torch.matmul(u, (t[:SEQ_VOCAB] * keep).t())
        loss = torch.nn.functional.cross_entropy(logits, pos)
        return (loss,) + torch.autograd.grad(loss, [u, t])

    loss, d_user, d_items = streamed()
    again = streamed()
    for a, b, what in zip((loss, d_user, d_items), again, ("loss", "d_user", "d_items")):
        require_equal(a, b, f"streamed CE {what}, run twice")
    lib_loss, lib_user, lib_items = library()
    torch.cuda.synchronize()
    errs = {"loss_rel": abs(loss.item() - lib_loss.item()) / abs(lib_loss.item()),
            "d_user_rel": rel_err(d_user, lib_user), "d_items_rel": rel_err(d_items, lib_items)}
    if (errs["loss_rel"] > CE_RTOL or errs["d_user_rel"] > CE_GRAD_REL_TOL
            or errs["d_items_rel"] > CE_GRAD_REL_TOL or bool(d_items[SEQ_VOCAB:].any())
            or bool(d_items[0].any())):
        raise RuntimeError(f"the streamed CE differs from F.cross_entropy: {errs}")
    del again, lib_user, lib_items
    flop = 4 * 2 * SEQ_BATCH * rows * SEQ_DIM  # logits, their recompute, d_user, d_items
    out = {"phase": "seq_ce", "batch": SEQ_BATCH, "items": SEQ_VOCAB, "table_rows": rows,
           "dim": SEQ_DIM, "chunk": ce.CHUNK_V, "chunks": -(-rows // ce.CHUNK_V),
           "loss": loss.item(), **errs, "loss_rtol": CE_RTOL, "grad_rel_tol": CE_GRAD_REL_TOL,
           "ms": median_ms([streamed], 5), "library_ms": median_ms([library], 5),
           # the same call at other chunk sizes: what CHUNK_V trades
           "ms_by_chunk": {c: median_ms([lambda c=c: streamed(c)], 5) for c in CE_CHUNK_SWEEP},
           "library": "F.cross_entropy over the materialized [1024, 1,000,000] logits, "
                      "forward and backward",
           "flop": flop, "bound_ms": flop / fp32 * 1e3, "bound_by": "operations (f32)"}
    out["seconds"] = time.perf_counter() - t_start
    return out


def write_seq_checkpoint(path: str) -> dict:
    """A SASRec checkpoint in the JAX package's layout at full width, made
    with numpy from the seed: the item table [padded_rows(1,000,000), 64]
    and two blocks of flax-named weights (small random biases and LayerNorm
    terms)."""
    rng = np.random.default_rng(SEED + 50)
    f = np.float32
    D, inner = SEQ_DIM, SEQ_CONFIG["inner_size"]

    def dense(n_in, n_out):
        return {"kernel": rng.standard_normal((n_in, n_out), dtype=f) * f(math.sqrt(2.0 / n_in)),
                "bias": rng.standard_normal(n_out, dtype=f) * f(0.1)}

    def norm():
        return {"scale": f(1) + rng.standard_normal(D, dtype=f) * f(0.1),
                "bias": rng.standard_normal(D, dtype=f) * f(0.1)}

    blocks = {}
    for i in range(SEQ_CONFIG["n_layers"]):
        blocks[f"TransformerBlock_{i}"] = {
            **{n: dense(D, D) for n in ("query", "key", "value", "dense")},
            "ffn_1": dense(D, inner), "ffn_2": dense(inner, D),
            "LayerNorm_0": norm(), "LayerNorm_1": norm()}
    table = rng.standard_normal((padded_rows(SEQ_VOCAB), D), dtype=f) * f(math.sqrt(2.0 / D))
    enc_dict = {"item_id": {"vocab_size": SEQ_VOCAB}}
    save_checkpoint(path, {"item_emb": {"table": table}, "self_attention": blocks}, None,
                    enc_dict=enc_dict)
    return enc_dict


def load_seq_model(path: str, enc_dict: dict, device: str, name: str = "SASRec",
                   config=None):
    """The sequence model ``name`` (SASRec with SEQ_CONFIG by default) at
    full width loaded from ``path`` onto ``device``."""
    model = port.get_model(name)(enc_dict=enc_dict, config=config or SEQ_CONFIG)
    SequenceTrainer(device=device).load_model(model, path)
    return model


def make_seq_requests(count: int, seed: int):
    """``count`` requests of SEQ_BATCH histories: lengths uniform in
    [1, SEQ_L], items first, then padding, as the sequence datasets lay
    them out."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        lengths = rng.integers(1, SEQ_L + 1, SEQ_BATCH)
        mask = (np.arange(SEQ_L)[None, :] < lengths[:, None]).astype(np.float32)
        items = rng.integers(1, SEQ_VOCAB, (SEQ_BATCH, SEQ_L))
        out.append({"hist_item_list": np.where(mask > 0, items, 0).astype(np.int32),
                    "hist_mask_list": mask})
    return out


def compare_topk(ids, scores, cpu_ids, cpu_scores) -> int:
    """Card top-k against the CPU's top-(k+1) of the same requests: scores
    within SCORE_ATOL everywhere, ids equal except at positions whose CPU
    score lies within SCORE_ATOL of a neighbour's.  Returns the count of
    such positions."""
    k = ids.shape[1]
    score_err = float(np.abs(scores - cpu_scores[:, :k]).max())
    if score_err > SCORE_ATOL:
        raise RuntimeError(f"card scores differ from the CPU's by {score_err}")
    near = np.abs(np.diff(cpu_scores, axis=1)) <= SCORE_ATOL  # [B, k]: p and p+1 tie
    tied = near.copy()
    tied[:, 1:] |= near[:, :-1]
    differ = ids != cpu_ids[:, :k]
    if bool((differ & ~tied).any()):
        raise RuntimeError("card top-k ids differ from the CPU's at untied positions")
    return int(differ.sum())


def phase_seq_serving(path: str, enc_dict: dict, device: str = "cuda"):
    """SASRec retrieval at full width from a JAX-layout checkpoint:
    SequenceTrainer.load_model, make_retrieval_scorer, 1024 histories a
    request, top-200 of the whole L2-normalized corpus."""
    t_start = time.perf_counter()
    model = load_seq_model(path, enc_dict, device)
    retrieve = make_retrieval_scorer(model, topk=SEQ_TOPK, device=device)
    setup_s = time.perf_counter() - t_start
    requests = make_seq_requests(SEQ_WARMUP + SEQ_REQUESTS, SEED + 51)

    # the main path: every count is 0 just before it and read just after
    reset_launches()
    outs, latencies = [], []
    for i, req in enumerate(requests):
        t0 = time.perf_counter()
        scores, ids = retrieve(req)
        if i >= SEQ_WARMUP:
            latencies.append(time.perf_counter() - t0)
        if (scores.shape != (SEQ_BATCH, SEQ_TOPK) or ids.shape != scores.shape
                or not np.all(np.isfinite(scores)) or bool((np.diff(scores, axis=1) > 0).any())
                or ids.min() < 1 or ids.max() >= SEQ_VOCAB):
            raise RuntimeError(f"bad retrieval answer for request {i}")
        if i < SEQ_CPU_CHECKS:
            outs.append((scores, ids))
    launches = read_launches()
    n = len(requests)
    require_launches(launches, {"embedding_lookup": n, "embedding_grad": 0, "fused_adam": 0,
                                "fused_encoder": n}, "seq_serving")

    cpu_model = load_seq_model(path, enc_dict, "cpu")
    cpu_retrieve = make_retrieval_scorer(cpu_model, topk=SEQ_TOPK + 1, device="cpu")
    emb_err, differing = 0.0, 0
    for req, (scores, ids) in zip(requests, outs):
        with torch.inference_mode():
            card_emb = model(model.upload_batch(req, torch.device(device)))["user_emb"]
            cpu_emb = cpu_model(cpu_model.upload_batch(req, torch.device("cpu")))["user_emb"]
        emb_err = max(emb_err, (card_emb.cpu() - cpu_emb).abs().max().item())
        cpu_scores, cpu_ids = cpu_retrieve(req)
        differing += compare_topk(ids, scores, cpu_ids, cpu_scores)
    if emb_err > USER_EMB_ATOL:
        raise RuntimeError(f"card user_emb differs from the CPU's by {emb_err} > {USER_EMB_ATOL}")
    del cpu_model, cpu_retrieve

    summary = {
        "phase": "seq_serving", "model": "SASRec", "config": SEQ_CONFIG, "vocab": SEQ_VOCAB,
        "table_rows": int(model.item_emb.table.shape[0]), "batch": SEQ_BATCH, "topk": SEQ_TOPK,
        "requests": SEQ_REQUESTS, "warmup": SEQ_WARMUP, "launches": launches,
        "launches_per_request": {k: v / n for k, v in launches.items()},
        "p50_ms": statistics.median(latencies) * 1e3,
        "p90_ms": float(np.percentile(latencies, 90)) * 1e3,
        "users_per_s": SEQ_REQUESTS * SEQ_BATCH / sum(latencies),
        "cpu_checked_requests": len(outs), "user_emb_max_abs_err_vs_cpu": emb_err,
        "user_emb_atol": USER_EMB_ATOL, "score_atol": SCORE_ATOL,
        "topk_positions_compared": len(outs) * SEQ_BATCH * SEQ_TOPK,
        "topk_positions_differing_at_ties": differing,
        "setup_s": setup_s, "seconds": time.perf_counter() - t_start,
    }
    return summary, model, requests[SEQ_WARMUP:SEQ_WARMUP + SEQ_PROFILED]


def phase_seq_profile(model, requests, phase: str = "seq_profile") -> dict:
    """Where a retrieval request's time goes.  Host stages, each ended by a
    synchronize: the id check, the check plus upload, the encoder (lookup,
    K4f, the last-position gather; IOCRec's K6f and disentangling too), the
    scoring (normalize and the [1024, 64] x [64, 1,000,000] product, one an
    interest), the top-200, the copy back.  Then torch.profiler over the
    scorer: device time by operation and the card's idle share."""
    from torch.profiler import ProfilerActivity, profile

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    with torch.inference_mode():
        items = l2_normalize(model.output_items())
    stages = {k: [] for k in ("check_ids", "check_and_upload", "encoder", "scoring", "topk",
                              "download")}
    for req in requests:
        t = [time.perf_counter()]
        check_item_ids(req["hist_item_list"], model.item_emb.vocab_size)
        t.append(time.perf_counter())
        inputs = model.upload_batch(req, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        with torch.inference_mode():
            user_emb = model(inputs)["user_emb"]
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            scores = score_items(l2_normalize(user_emb), items)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            top, ids = torch.topk(scores, SEQ_TOPK, dim=-1)
            ids = ids.to(torch.int32)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
        top.cpu().numpy(), ids.cpu().numpy()
        t.append(time.perf_counter())
        for key, a, b in zip(stages, t, t[1:]):
            stages[key].append(b - a)
    del items, scores

    retrieve = make_retrieval_scorer(model, topk=SEQ_TOPK, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for req in requests:
            retrieve(req)
        wall_s = time.perf_counter() - t0
    busy_s, ops = profile_ops(prof, len(requests), "request")
    n = len(requests)
    return {
        "phase": phase, "requests": n,
        "host_stage_p50_ms": {k: statistics.median(v) * 1e3 for k, v in stages.items()},
        "wall_ms_per_request": wall_s * 1e3 / n,
        "device_busy_ms_per_request": busy_s * 1e3 / n,
        "device_idle_share": 1.0 - busy_s / wall_s, "device_ops": ops,
        "seconds": time.perf_counter() - t_start,
    }


def phase_seq_eval(device: str = "cuda", name: str = "SASRec", config=None,
                   kernels=("embedding_lookup", "fused_encoder")) -> dict:
    """SequenceTrainer.evaluate_model on the bundled MovieLens sample
    (get_dataloader, task_type "sequence", max_length 50), the model ``name``
    at D=64 from seeded weights, on the card and on the CPU: recall, ndcg and
    hit rate at 20, 50 and 100 must be equal (both are rounded to 4 dp).
    Each of ``kernels`` launches once an eval batch."""
    import pandas as pd

    t_start = time.perf_counter()
    dfs = [pd.read_csv(os.path.join(SEQ_DATA, f"sample_{n}.csv"))
           for n in ("train", "valid", "test")]
    schema = {"user_col": "user_id", "item_col": "item_id", "time_col": "timestamp",
              "max_length": SEQ_L, "task_type": "sequence"}
    loaders = get_dataloader(*dfs, schema, batch_size=SEQ_BATCH)
    model = port.get_model(name)(enc_dict=loaders[3], config=config or SEQ_CONFIG, seed=SEED)
    cpu_model = copy.deepcopy(model)  # the same weights, kept on the CPU
    splits = {"valid": loaders[1], "test": loaders[2]}
    reset_launches()
    card = {k: SequenceTrainer(device=device).evaluate_model(model, v)
            for k, v in splits.items()}
    launches = read_launches()
    batches = sum(len(v) for v in splits.values())
    require_launches(launches, {k: batches for k in kernels}, f"{name} eval")
    cpu = {k: SequenceTrainer(device="cpu").evaluate_model(cpu_model, v)
           for k, v in splits.items()}
    if card != cpu:
        raise RuntimeError(f"card metrics {card} differ from the CPU's {cpu}")
    return {"phase": "seq_eval" if name == "SASRec" else f"{name.lower()}_eval", "model": name,
            "users": {k: len(v.dataset)
                      for k, v in splits.items()},
            "vocab": loaders[3]["item_id"]["vocab_size"], "launches": launches,
            "metrics": card, "equal_to_cpu": True, "seconds": time.perf_counter() - t_start}


SEQ_TRAIN_BATCHES, SEQ_VALID_BATCHES = 16, 2   # an epoch; bench-shape batches
SEQ_STD_STEPS, SEQ_BF16_STEPS = 6, 6            # standard-step and bf16-moment legs
SEQ_CPU_VOCAB, SEQ_CPU_BATCH = 100_000, 256     # card against CPU: a cut corpus
SEQ_LOSS_RTOL = 1e-5       # card against CPU: losses over three steps
SEQ_DENSE_ATOL = 1e-4      # ... dense parameters after one step (first run: 1.5e-5;
                           # key biases within 2 lr, see phase_seq_card_vs_cpu)
SEQ_TABLE_ATOL = 1e-6      # ... the table, on all but SEQ_HANDFUL elements
SEQ_HANDFUL = 512          # (first run: 72 of 6,815,744, the largest 5.5e-5)
SEQ_TRAIN_PROFILED = 6     # fused steps traced by the profiler


class _SeqArrays:
    """Sequence batches for DataLoader: ``arrays`` and, for a valid set,
    ``get_test_gd`` (each user's held-out items)."""

    def __init__(self, arrays, test_gd=None):
        self.arrays = arrays
        self.test_gd = test_gd

    def __len__(self):
        return len(self.arrays["hist_item_list"])

    def get_test_gd(self):
        return self.test_gd


def seq_train_loader(batches: int, seed: int, vocab: int = 0, batch: int = 0) -> DataLoader:
    """bench.py's sequence batches: ids uniform in [1, vocab) at every
    position, masks of density 0.9, targets uniform in [1, vocab) (vocab
    and batch 0: SEQ_VOCAB and SEQ_BATCH)."""
    vocab, batch = vocab or SEQ_VOCAB, batch or SEQ_BATCH
    rng = np.random.default_rng(seed)
    n = batches * batch
    arrays = {"hist_item_list": rng.integers(1, vocab, (n, SEQ_L), dtype=np.int32),
              "hist_mask_list": (rng.random((n, SEQ_L)) < 0.9).astype(np.float32),
              "target_item": rng.integers(1, vocab, n, dtype=np.int32)}
    return DataLoader(_SeqArrays(arrays), batch_size=batch)


def seq_valid_loader(batches: int, seed: int) -> DataLoader:
    """Valid users: prefix histories and five held-out items each."""
    rng = np.random.default_rng(seed)
    n = batches * SEQ_BATCH
    lengths = rng.integers(1, SEQ_L + 1, n)
    mask = (np.arange(SEQ_L)[None, :] < lengths[:, None]).astype(np.float32)
    users = np.array([f"u{i}" for i in range(n)], dtype=object)
    arrays = {"hist_item_list": np.where(mask > 0, rng.integers(1, SEQ_VOCAB, (n, SEQ_L)),
                                         0).astype(np.int32),
              "hist_mask_list": mask, "user": users}
    gd = {u: rng.integers(1, SEQ_VOCAB, 5).tolist() for u in users}
    return DataLoader(_SeqArrays(arrays, gd), batch_size=SEQ_BATCH)


def timed_seq_fit(trainer: SequenceTrainer, model, train_loader, valid_loader, epochs: int,
                  device: str = "cuda"):
    """trainer.fit with each step timed to the end of its device work (a
    synchronize after each step).  Returns (step seconds, step losses)."""
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
    trainer.fit(model, train_loader, valid_loader, epoch=epochs, lr=LR,
                use_earlystopping=valid_loader is not None, monitor_metric="recall@20",
                log_rounds=10 ** 9, seed=SEED)
    del trainer._step
    return times, [float(x) for x in losses]


def phase_seq_training(path: str, enc_dict: dict, ckpt_dir: str, device: str = "cuda"):
    """SequenceTrainer.fit on SASRec at full width (dropout 0.1) from the
    JAX-layout checkpoint: 2 epochs of bench-shape batches with validation,
    log.csv, checkpoints and early stopping, on the sequence fused step
    (K1, K4f, K4b, K3 once a step).  Then standard steps (K1, K4f, K4b, K2)
    and fused steps with bfloat16 moments."""
    t_start = time.perf_counter()
    train_loader = seq_train_loader(SEQ_TRAIN_BATCHES, SEED + 70)
    valid_loader = seq_valid_loader(SEQ_VALID_BATCHES, SEED + 71)
    model = load_seq_model(path, enc_dict, device)
    trainer = SequenceTrainer(device=device, model_ckpt_dir=ckpt_dir)
    setup_s = time.perf_counter() - t_start

    # the main path: every count is 0 just before it and read just after
    reset_launches()
    t0 = time.perf_counter()
    times, losses = timed_seq_fit(trainer, model, train_loader, valid_loader, EPOCHS, device)
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    steps, evals = EPOCHS * SEQ_TRAIN_BATCHES, EPOCHS * SEQ_VALID_BATCHES
    require_launches(launches, {"embedding_lookup": steps + evals, "embedding_grad": 0,
                                "fused_adam": steps, "fused_encoder": steps + evals,
                                "fused_encoder_bwd": steps}, "seq fused fit")
    if not trainer._train_step.fused:
        raise RuntimeError("fit did not take the sequence fused step")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not (np.all(np.isfinite(losses)) and last < first):
        raise RuntimeError(f"the training loss did not fall: {losses}")
    files = sorted(os.listdir(ckpt_dir))
    want = ({f"model_e_{i}.ckpt" for i in range(1, EPOCHS + 1)}
            | {"model_best.ckpt", "log.csv"})
    if not want <= set(files):
        raise RuntimeError(f"fit's files missing: {sorted(want - set(files))} of {files}")
    with open(os.path.join(ckpt_dir, "log.csv")) as f:
        log_rows = f.read().strip().splitlines()
    del trainer, model

    def leg(env: dict, count: int):
        loader = DataLoader(_SeqArrays({k: v[:count * SEQ_BATCH] for k, v in
                                        train_loader.dataset.arrays.items()}),
                            batch_size=SEQ_BATCH)
        leg_model = load_seq_model(path, enc_dict, device)
        leg_trainer = SequenceTrainer(device=device, model_ckpt_dir=ckpt_dir)
        os.environ.update(env)
        try:
            reset_launches()
            leg_times, leg_losses = timed_seq_fit(leg_trainer, leg_model, loader, None, 1,
                                                  device)
            counts = read_launches()
        finally:
            for k in env:
                del os.environ[k]
        if not np.all(np.isfinite(leg_losses)):
            raise RuntimeError(f"a training leg ({env}) did not run cleanly: {leg_losses}")
        return leg_trainer._train_step, leg_times, leg_losses, counts

    std_step, std_times, std_losses, std_launches = leg({"REC_PANGU_TPU_FUSED_ADAM": "0"},
                                                        SEQ_STD_STEPS)
    require_launches(std_launches, {"embedding_lookup": SEQ_STD_STEPS,
                                    "embedding_grad": SEQ_STD_STEPS, "fused_adam": 0,
                                    "fused_encoder": SEQ_STD_STEPS,
                                    "fused_encoder_bwd": SEQ_STD_STEPS}, "seq standard fit")
    bf_step, bf_times, bf_losses, bf_launches = leg({"REC_PANGU_TPU_MOMENT_DTYPE": "bf16"},
                                                    SEQ_BF16_STEPS)
    require_launches(bf_launches, {"embedding_lookup": SEQ_BF16_STEPS, "embedding_grad": 0,
                                   "fused_adam": SEQ_BF16_STEPS,
                                   "fused_encoder": SEQ_BF16_STEPS,
                                   "fused_encoder_bwd": SEQ_BF16_STEPS}, "seq bf16 fit")
    if std_step.fused or not bf_step.fused or bf_step.mu.dtype != torch.bfloat16:
        raise RuntimeError("a training leg took the wrong step")
    summary = {
        "phase": "seq_training", "model": "SASRec", "config": SEQ_CONFIG, "dropout": DROP,
        "vocab": SEQ_VOCAB, "batch": SEQ_BATCH, "epochs": EPOCHS,
        "steps_per_epoch": SEQ_TRAIN_BATCHES, "valid_batches": SEQ_VALID_BATCHES, "lr": LR,
        "launches": launches,
        "launches_per_step": {k: launches[k] / steps for k in ("fused_adam", "fused_encoder_bwd")},
        "fused": step_stats(times, SEQ_BATCH), "fit_s": fit_s, "setup_s": setup_s,
        "loss_first3": first, "loss_last3": last, "losses": losses, "files": files,
        "log_csv_rows": len(log_rows) - 1,
        "standard_launches": std_launches, "standard": step_stats(std_times, SEQ_BATCH),
        "standard_losses": std_losses,
        "bf16_launches": bf_launches, "bf16": step_stats(bf_times, SEQ_BATCH),
        "bf16_losses": bf_losses, "seconds": time.perf_counter() - t_start,
    }
    return summary, train_loader


def phase_seq_card_vs_cpu(devices=("cuda", "cpu")) -> dict:
    """The first three sequence fused steps on the card and on the CPU, from
    the same weights, batches and dropout seeds (the masks are the same
    hash on both): losses, dense parameters and the table."""
    from rec_pangu_tpu_torch.train.fused_update import maybe_enable_seq_fused_update

    t_start = time.perf_counter()
    loader = seq_train_loader(CPU_STEPS, SEED + 81, SEQ_CPU_VOCAB, SEQ_CPU_BATCH)
    runs = {}
    enc_dict = {"item_id": {"vocab_size": SEQ_CPU_VOCAB}}
    for dev in devices:
        model = port.get_model("SASRec")(enc_dict=enc_dict, config=SEQ_CONFIG, seed=SEED + 80)
        model = model.to(dev).train()
        step = maybe_enable_seq_fused_update(model, LR, CPU_STEPS,
                                             generator=torch.Generator().manual_seed(SEED))
        losses = []
        for i, batch in enumerate(loader):
            out = step(model.upload_batch(batch, torch.device(dev), train=True), i)
            losses.append(float(out["loss"].detach()))
            if i == 0:
                after_one = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        runs[dev] = (losses, after_one)
    (card_losses, card), (cpu_losses, cpu) = (runs[d] for d in devices)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    diffs = {k: (card[k] - cpu[k]).abs() for k in cpu}
    table_key = "item_emb.table"
    # Adam's first step is lr * g / (|g| + eps), so a gradient within rounding
    # of 0 (the CE gives every item p * u / B) may move by up to lr: a table
    # element beyond SEQ_TABLE_ATOL is such a one.  A key projection's bias
    # has an exact gradient of 0 (the softmax does not change when a row of
    # scores moves by one constant): rounding noise, held within 2 lr
    key_bias = [k for k in cpu if k.endswith("key.bias")]
    dense_err = max(d.max().item() for k, d in diffs.items()
                    if k != table_key and k not in key_bias)
    key_bias_err = max(diffs[k].max().item() for k in key_bias)
    table = diffs[table_key]
    beyond = int((table > SEQ_TABLE_ATOL).sum().item())
    summary = {"phase": "seq_card_vs_cpu", "steps": CPU_STEPS, "vocab": SEQ_CPU_VOCAB,
               "batch": SEQ_CPU_BATCH, "dropout": DROP, "card_losses": card_losses,
               "cpu_losses": cpu_losses, "loss_max_rel_diff": loss_rel,
               "dense_max_abs_diff": dense_err, "key_bias_max_abs_diff": key_bias_err,
               "table_max_abs_diff": table.max().item(), "table_elements_beyond_atol": beyond,
               "table_elements": table.numel(), "loss_rtol": SEQ_LOSS_RTOL,
               "dense_atol": SEQ_DENSE_ATOL, "table_atol": SEQ_TABLE_ATOL,
               "handful": SEQ_HANDFUL,
               "seconds": time.perf_counter() - t_start}
    if (loss_rel > SEQ_LOSS_RTOL or dense_err > SEQ_DENSE_ATOL or key_bias_err > 2 * LR
            or beyond > SEQ_HANDFUL or table.max().item() > 2 * LR):
        raise RuntimeError(f"the card's sequence training differs from the CPU's: {summary}")
    return summary


def phase_seq_train_profile(path: str, enc_dict: dict, batches, ckpt_dir: str,
                            load=None, phase: str = "seq_train_profile") -> dict:
    """Where a sequence fused step's time goes: host stages, each ended by a
    synchronize (the trainer's host keys: IOCRec's and ContraRec's views,
    CLRec's lookup_all; the id check and upload, the step),
    then torch.profiler's device time by operation and the card's idle share.
    ``load`` loads the model (SASRec's by default)."""
    from torch.profiler import ProfilerActivity, profile

    from rec_pangu_tpu_torch.train.fused_update import maybe_enable_seq_fused_update

    t_start = time.perf_counter()
    model = (load or load_seq_model)(path, enc_dict, "cuda").train()
    trainer = SequenceTrainer(device="cuda", model_ckpt_dir=ckpt_dir)
    trainer.model, trainer._fit_device = model, torch.device("cuda")
    trainer._train_step = maybe_enable_seq_fused_update(
        model, LR, len(batches), generator=torch.Generator().manual_seed(SEED))
    for batch in batches[:2]:  # warm
        trainer._step(batch)
    torch.cuda.synchronize()
    stages = {"host_keys": [], "check_and_upload": [], "step": []}
    for i, batch in enumerate(batches):
        t = [time.perf_counter()]
        batch = trainer._attach_host_keys(batch)
        t.append(time.perf_counter())
        inputs = model.upload_batch(batch, trainer._fit_device, train=True)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        trainer._train_step(inputs, i)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for key, a, b in zip(stages, t, t[1:]):
            stages[key].append(b - a)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            trainer._step(batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    busy_s, ops = profile_ops(prof, len(batches), "step")
    n = len(batches)
    return {"phase": phase, "steps": n,
            "host_stage_p50_ms": {k: statistics.median(v) * 1e3 for k, v in stages.items()},
            "wall_ms_per_step": wall_s * 1e3 / n,
            "device_busy_ms_per_step": busy_s * 1e3 / n,
            "device_idle_share": 1.0 - busy_s / wall_s, "device_ops": ops,
            "seconds": time.perf_counter() - t_start}


# ------------------------------------------------------------------ IOCRec
# IOCRec at bench.py's sequence width (bench.py:135-177) with IOCRec's own
# defaults (rec_pangu_tpu/models/sequence/iocrec.py:252-283)
IOC_CONFIG = {"embedding_dim": SEQ_DIM, "max_length": SEQ_L, "K": 4, "num_blocks": 3,
              "num_heads": 2, "ffn_hidden": 128, "layer_norm_eps": 1e-12,
              "hidden_dropout": 0.5, "attn_dropout": 0.5, "lamda": 0.1, "tao": 2,
              "item_col": "item_id"}
IOC_DROP = 0.5
IOC_VIEWS = 3 * SEQ_BATCH          # a training step encodes [hist; aug1; aug2]
IOC_CPU_CHECKS, IOC_CPU_USERS = 2, 128  # requests held against the CPU, and their users
FIT_EPOCHS, FIT_TRAIN_BATCHES, FIT_VALID_BATCHES = 1, 8, 1  # the fit of IOCRec and later models
IOC_STD_STEPS, IOC_PROFILED = 3, 3
IOC_CPU_BATCH = 128               # card against CPU: 100,000 items, 128 histories
IOC_ZERO_GRAD = ("key.bias", "K_linear.bias", "layer_norm_2.bias")  # exact gradients of 0
IOC_LOSS_RTOL = 1e-5              # card against CPU: the losses (see phase_iocrec_card_vs_cpu)
IOC_LATER_LOSS_RTOL = 1e-4        # ... steps 2 and 3 at LR (first run: 1.7e-5, 4.9e-5)
IOC_SMALL_LR = 1e-4
IOC_GRAD_REL_TOL = 1e-5           # ... the first step's gradient of each leaf, of its largest
                                  # entry (seen: 2.9e-6); exact zeros, of their weight's (1.3e-7)
IOC_KINK_GRAD_REL_TOL = 1e-2      # ... of the leaves behind the local encoder's relu (2.9e-3)
IOC_KINK_PATH = ("item_emb.", "position_embedding", "input_layer_norm.", "local_encoder.")
IOC_DENSE_HANDFUL = 16            # dense elements allowed past SEQ_DENSE_ATOL (2 lr at most;
                                  # seen: 4)
GA_ATOL = 1e-5                    # K6f against plain (outputs of order 1)
GA_REL_TOL = 1e-5                 # K6b: each gradient, of the array's largest entry
GA_SLICES = 264                   # K6b's gradient slices (kSlices in csrc/global_attn.cu)
MM_REL_TOL = 1e-5                 # K5f: lse; K5b: du and d_items, of each array's largest entry
MM_LAUNCHES = 2                   # K5 calls a timing graph holds (tens of ms each)


def ga_params(dim: int, length: int, gen) -> list:
    """(wk, bk, wv, bv, q_s) at the JAX package's init, small random biases."""
    def kaiming(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device) * math.sqrt(2.0 / shape[1])

    return [kaiming(dim, dim), torch.randn(dim, generator=gen, device=gen.device) * 0.1,
            kaiming(dim, dim), torch.randn(dim, generator=gen, device=gen.device) * 0.1,
            kaiming(length, dim)]


def ga_work(n: int, length: int, dim: int) -> int:
    """K6f's FLOP: the k and v projections, the scores and P v."""
    return n * (4 * length * dim * dim + 4 * length * length * dim)


def ga_bwd_work(n: int, length: int, dim: int) -> int:
    """K6b's FLOP: the recomputed k, v and scores (not P v, which the
    gradients do not need), then dv, dP, dQ and dk (2 L^2 D each), dWk and
    dWv (2 L D^2 each) and dx (4 L D^2)."""
    return n * (12 * length * dim * dim + 10 * length * length * dim)


def ga_grad_errs(got, want) -> dict:
    """dx's and each gradient's largest difference over the array's largest
    entry; the key bias, whose exact gradient is 0 (each score row moves by
    one constant), over the value bias's largest gradient."""
    names = ("dx",) + gattn.PARAM_NAMES
    errs = {}
    for name, a, b in zip(names, got, want):
        scale = want[names.index("bv")] if name == "bk" else b
        errs[name] = ((a - b).abs().max() / scale.abs().max().clamp(min=1e-30)).item()
    return errs


def plain_ga_grads(x, params, dy, rate: float):
    xs = x.detach().clone().requires_grad_()
    ps = [p.detach().clone().requires_grad_() for p in params]
    y = gattn.global_attn_reference(xs, ps, True, rate, 7)
    return torch.autograd.grad(y, [xs] + ps, dy)


def check_global_attn(x, params, rate: float, what: str) -> dict:
    """K6f, and K6b under autograd, against the plain version with the same
    dropout masks, each run twice for the same bits; held as ga_grad_errs
    says."""
    gen = torch.Generator(device=x.device).manual_seed(17)
    dy = torch.randn(x.shape, generator=gen, device=x.device)

    def run():
        xs = x.detach().clone().requires_grad_()
        ps = [p.detach().clone().requires_grad_() for p in params]
        y = gattn.global_attn(xs, ps, 7, rate, True)
        return (y.detach(),) + torch.autograd.grad(y, [xs] + ps, dy)

    got, again = run(), run()
    for a, b, part in zip(got, again, ("y", "dx") + gattn.PARAM_NAMES):
        require_equal(a, b, f"{what}, {part}, run twice")
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise RuntimeError(f"{what}: non-finite global attention output or gradient")
    with torch.no_grad():
        want_y = gattn.global_attn_reference(x, params, True, rate, 7)
    errs = {"y_abs": (got[0] - want_y).abs().max().item(),
            **ga_grad_errs(got[1:], plain_ga_grads(x, params, dy, rate))}
    if errs["y_abs"] > GA_ATOL or max(v for k, v in errs.items() if k != "y_abs") > GA_REL_TOL:
        raise RuntimeError(f"{what}: the global attention kernels differ from plain: {errs}")
    return {"case": what, "dropout": rate, **errs}


def check_ga_forward(x, params, rate: float, resident, what: str) -> dict:
    """K6f's variant ``resident`` (launch_forward) against the plain version
    with the same dropout masks, run twice for the same bits."""
    got = gattn.launch_forward(x, params, rate, 7, resident=resident)
    require_equal(got, gattn.launch_forward(x, params, rate, 7, resident=resident),
                  f"{what}, y, run twice")
    with torch.no_grad():
        err = (got - gattn.global_attn_reference(x, params, True, rate, 7)).abs().max().item()
    if not bool(torch.isfinite(got).all()) or err > GA_ATOL:
        raise RuntimeError(f"{what}: the global attention forward differs from plain by {err}")
    return {"case": what, "y_abs": err}


def check_ga_backward(x, params, dy, rate: float, resident, what: str) -> dict:
    """K6b's variant ``resident`` (launch_backward) against the plain
    version's autograd, run twice for the same bits."""
    got = gattn.launch_backward(x, params, dy, rate, 7, resident=resident)
    again = gattn.launch_backward(x, params, dy, rate, 7, resident=resident)
    got, again = (got[0],) + got[1], (again[0],) + again[1]
    for a, b, part in zip(got, again, ("dx",) + gattn.PARAM_NAMES):
        require_equal(a, b, f"{what}, {part}, run twice")
    errs = ga_grad_errs(got, plain_ga_grads(x, params, dy, rate))
    if not all(bool(torch.isfinite(t).all()) for t in got) or max(errs.values()) > GA_REL_TOL:
        raise RuntimeError(f"{what}: the global attention backward differs from plain: {errs}")
    return {"case": what, **errs}


def ga_library(xs, ps):
    """F.linear twice and scaled_dot_product_attention (scale 1): the
    library's global attention, no dropout."""
    import torch.nn.functional as F

    N, L, D = xs.shape
    k = F.linear(xs, ps[0].t(), ps[1])
    v = F.linear(xs, ps[2].t(), ps[3])
    q = ps[4].expand(N, 1, L, D)
    return F.scaled_dot_product_attention(q, k[:, None], v[:, None], scale=1.0)[:, 0]


def ga_reference_times(x, params, dy) -> dict:
    """Times of the plain version (dropout IOC_DROP) and the library call:
    forward, and forward+backward under autograd; the backward alone is the
    difference (autograd's backward runs on its forward's stream, so it
    cannot be captured alone)."""
    grad_params = [p.detach().clone().requires_grad_() for p in params]
    plain = lambda xs, ps: gattn.global_attn_reference(xs, ps, True, IOC_DROP, 7)  # noqa: E731

    def forward(fn):
        def call():
            with torch.no_grad():
                fn(x, params)
        return [call]

    def fwd_bwd(fn):
        def call():
            xs = x.detach().requires_grad_()
            torch.autograd.grad(fn(xs, grad_params), [xs] + grad_params, dy)
        return [call]

    t = {"plain_fwd": median_ms(forward(plain)), "plain_fwd_bwd": median_ms(fwd_bwd(plain)),
         "library_fwd": median_ms(forward(ga_library)),
         "library_fwd_bwd": median_ms(fwd_bwd(ga_library))}
    t["plain_bwd"] = t["plain_fwd_bwd"] - t["plain_fwd"]
    t["library_bwd"] = t["library_fwd_bwd"] - t["library_fwd"]
    return t


def phase_global_attn(bandwidth: float, fp32: float) -> tuple:
    """K6f and K6b against the plain version's forward and autograd at the
    training shape (3072 views of 50 x 64) and the serving shape (1024),
    dropout 0 and 0.5, and at edge shapes (N=1, L=1, L=64 with D=128, odd
    sizes); K6f and K6b alone at the edges of their partitions (G - 1, G,
    G + 1 and 2 G + 1 views; G the forward's groups on this card, GA_SLICES
    the backward's slices) and with their weights streamed from device
    memory beside the resident variants at the training shape; times of the
    kernels, the plain version and F.linear twice plus
    scaled_dot_product_attention (scale 1).  Returns the two kernel rows."""
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 100)
    params = ga_params(SEQ_DIM, SEQ_L, gen)

    def x_of(n, length, dim):
        return torch.randn(n, length, dim, generator=gen, device=dev) * math.sqrt(2.0 / dim)

    x = x_of(IOC_VIEWS, SEQ_L, SEQ_DIM)
    cases = [check_global_attn(x, params, rate, f"training shape, dropout {rate}")
             for rate in (0.0, IOC_DROP)]
    cases.append(check_global_attn(x[:SEQ_BATCH], params, 0.0, "serving shape"))
    for n, length, dim in ((1, SEQ_L, SEQ_DIM), (5, 1, SEQ_DIM), (3, 64, 128), (7, 13, 24)):
        cases.append(check_global_attn(x_of(n, length, dim), ga_params(dim, length, gen),
                                       IOC_DROP, f"N={n} L={length} D={dim}"))
    groups = gattn.forward_groups(IOC_VIEWS, SEQ_L, SEQ_DIM)
    fwd_cases = [check_ga_forward(x[:n], params, IOC_DROP, None, f"K6f N={n}")
                 for n in (groups - 1, groups, groups + 1, 2 * groups + 1)]
    fwd_cases += [check_ga_forward(x, params, IOC_DROP, resident,
                                   f"K6f training shape, resident={resident}")
                  for resident in (True, False)]
    require_equal(gattn.launch_forward(x, params, IOC_DROP, 7, resident=True),
                  gattn.launch_forward(x, params, IOC_DROP, 7, resident=False),
                  "K6f, resident and streamed variants")
    dy = torch.randn(x.shape, generator=gen, device=dev)
    bwd_cases = [check_ga_backward(x[:n], params, dy[:n], IOC_DROP, None, f"K6b N={n}")
                 for n in (GA_SLICES - 1, GA_SLICES, GA_SLICES + 1, 2 * GA_SLICES + 1)]
    bwd_cases += [check_ga_backward(x, params, dy, IOC_DROP, resident,
                                    f"K6b training shape, resident={resident}")
                  for resident in (True, False)]
    # the masks: another seed changes them; the keep share at the training shape
    with torch.no_grad():
        seed_changes = not torch.equal(gattn.global_attn(x, params, 7, IOC_DROP, True),
                                       gattn.global_attn(x, params, 8, IOC_DROP, True))
    keep_share = float((gattn.output_mask(7, IOC_VIEWS, SEQ_L, SEQ_DIM, IOC_DROP, dev) > 0)
                       .float().mean())
    if not seed_changes or abs(keep_share - (1 - IOC_DROP)) > 1e-3:
        raise RuntimeError(f"global attention dropout: another seed changes the masks "
                           f"{seed_changes}, keep share {keep_share}")

    with torch.no_grad():
        lib_err = (ga_library(x, params) - gattn.global_attn(x, params)).abs().max().item()
    if lib_err > GA_ATOL:
        raise RuntimeError(f"the library's attention differs from K6f by {lib_err}")

    serving = x[:SEQ_BATCH]

    def library_serving():
        with torch.no_grad():
            ga_library(serving, params)

    t = {"fwd": median_ms([lambda: gattn.launch_forward(x, params, IOC_DROP, 7)]),
         "fwd_streamed": median_ms(
             [lambda: gattn.launch_forward(x, params, IOC_DROP, 7, resident=False)]),
         "fwd_serving": median_ms([lambda: gattn.launch_forward(serving, params, 0.0, 0)]),
         "library_fwd_serving": median_ms([library_serving]),
         "bwd": median_ms([lambda: gattn.launch_backward(x, params, dy, IOC_DROP, 7)]),
         "bwd_streamed": median_ms(
             [lambda: gattn.launch_backward(x, params, dy, IOC_DROP, 7, resident=False)]),
         **ga_reference_times(x, params, dy)}
    flop = ga_work(IOC_VIEWS, SEQ_L, SEQ_DIM)
    n_el = IOC_VIEWS * SEQ_L * SEQ_DIM
    param_bytes = sum(p.numel() * 4 for p in params)
    rows = []
    for name, work, moved, ms, plain_ms, lib_ms, replaces in (
            ("global_attn", flop, 2 * n_el * 4 + param_bytes, t["fwd"], t["plain_fwd"],
             t["library_fwd"], "rec_pangu_tpu/ops/kernels/global_attn.py:69"),
            ("global_attn_bwd", ga_bwd_work(IOC_VIEWS, SEQ_L, SEQ_DIM),
             3 * n_el * 4 + 2 * param_bytes, t["bwd"], t["plain_bwd"], t["library_bwd"],
             "rec_pangu_tpu/ops/kernels/global_attn.py:78")):
        by_ops, by_bytes = work / fp32 * 1e3, moved / bandwidth * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": "rec_pangu_tpu_torch/csrc/global_attn.cu",
            "replaces": replaces, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "flop": work, "bytes": moved, "ops_bound_ms": by_ops, "bytes_bound_ms": by_bytes})
    fwd_row, bwd_row = rows
    fwd_row.update({
        "max_abs_err": max(c["y_abs"] for c in cases + fwd_cases),
        "tolerance": f"y within atol {GA_ATOL} of the plain version, dropout masks equal",
        "bound_share": fwd_row["bound_ms"] / t["fwd"], "library_share": t["library_fwd"] / t["fwd"],
        "ms_streamed": t["fwd_streamed"], "groups": groups,
        "ms_serving": t["fwd_serving"], "library_ms_serving": t["library_fwd_serving"],
        "bound_ms_serving": ga_work(SEQ_BATCH, SEQ_L, SEQ_DIM) / fp32 * 1e3,
        "library": "F.linear x2 + F.scaled_dot_product_attention(Q_s.expand(N, 1, L, D), k, v, "
                   "scale=1.0), no dropout", "library_max_abs_err": lib_err,
        "keep_share": keep_share, "seed_changes_masks": seed_changes, "cases": fwd_cases,
        "shape": {"N": IOC_VIEWS, "L": SEQ_L, "D": SEQ_DIM, "dropout": IOC_DROP}})
    grad_names = ("dx",) + gattn.PARAM_NAMES
    bwd_row.update({
        "max_abs_err": max(max(c[k] for k in grad_names) for c in cases + bwd_cases),
        "tolerance": f"dx and each gradient within {GA_REL_TOL} of the array's largest entry "
                     f"(bk, whose exact value is 0, of dbv's); max_abs_err is that relative error",
        "bound_share": bwd_row["bound_ms"] / t["bwd"], "library_share": t["library_bwd"] / t["bwd"],
        "ms_streamed": t["bwd_streamed"],
        "library": "autograd of the library forward above (plain_ms and library_ms: "
                   "forward+backward minus forward)",
        "cases": cases + bwd_cases, "seconds": time.perf_counter() - t_start})
    return fwd_row, bwd_row


def mm_work(batch: int, k: int, dim: int, items: int) -> int:
    """K5f's FLOP, one K-max logits product: 2 B K D V over the valid items."""
    return 2 * batch * k * dim * items


def mm_bwd_work(batch: int, k: int, dim: int, items: int) -> int:
    """K5b's FLOP: z recomputed (2 B K D V), then one D-vector multiply-add
    per (b, v) into du and one into d_items, since each (b, v) reaches only
    its winning interest: 2 B V D (K + 2)."""
    return 2 * batch * items * dim * (k + 2)


def check_multimax(u, items, valid_v: int, zero_row0: bool, what: str) -> dict:
    """K5f and K5b against the plain versions on the same inputs, each run
    twice for the same bits: lse within MM_REL_TOL of its largest entry, du
    and d_items within MM_REL_TOL of each array's largest entry."""
    lse = mmce.multimax_lse(u, items, valid_v, zero_row0)
    require_equal(mmce.multimax_lse(u, items, valid_v, zero_row0), lse, f"{what}, lse twice")
    ref_lse = mmce.multimax_lse_reference(u, items, valid_v, zero_row0)
    du, di = mmce.multimax_grads(u, items, lse, valid_v, zero_row0)
    du2, di2 = mmce.multimax_grads(u, items, lse, valid_v, zero_row0)
    require_equal(du2, du, f"{what}, du twice")
    require_equal(di2, di, f"{what}, d_items twice")
    del du2, di2
    ref_du, ref_di = mmce.multimax_grads_reference(u, items, lse, valid_v, zero_row0)
    torch.cuda.synchronize()
    out = {"case": what, "lse": rel_err(lse, ref_lse), "du": rel_err(du, ref_du),
           "d_items": rel_err(di, ref_di),
           "padding_and_row0_zero": not bool(di[valid_v:].any())
           and not (zero_row0 and bool(di[0].any()))}
    if (max(out["lse"], out["du"], out["d_items"]) > MM_REL_TOL
            or not out["padding_and_row0_zero"]
            or not all(bool(torch.isfinite(t).all()) for t in (lse, du, di))):
        raise RuntimeError(f"{what}: the K-max CE kernels differ from plain: {out}")
    return out


def phase_multimax_ce(bandwidth: float, fp32: float) -> tuple:
    """K5f and K5b against their plain versions at the bench shape (1024
    users x 4 interests x 64 against the raw [1,007,616, 64] table, 1,000,000
    valid items, row 0 read as zero) and at edge shapes (odd item counts, one
    valid item, K=1 and 3, D=24 and 128, all interests equal); times of the
    kernels and the plain versions (no PyTorch call computes the K-max CE).
    Returns the two kernel rows."""
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 110)
    rows = padded_rows(SEQ_VOCAB)
    table = torch.randn(rows, SEQ_DIM, generator=gen, device=dev) * math.sqrt(2.0 / SEQ_DIM)
    u = torch.randn(SEQ_BATCH, 4, SEQ_DIM, generator=gen, device=dev) * 0.5
    cases = [check_multimax(u, table, SEQ_VOCAB, True, "bench shape")]
    for b, k, dim, n, valid, z0 in ((3, 4, SEQ_DIM, 1001, 999, True),
                                    (37, 3, 24, 5000, 5000, False),
                                    (5, 1, 128, 300, 257, True), (64, 2, SEQ_DIM, 1, 1, False)):
        cases.append(check_multimax(torch.randn(b, k, dim, generator=gen, device=dev) * 0.5,
                                    torch.randn(n, dim, generator=gen, device=dev), valid, z0,
                                    f"B={b} K={k} D={dim} rows={n} valid={valid} row0={z0}"))
    # all interests equal: every item ties, the lowest interest takes it all
    same = torch.randn(16, 1, SEQ_DIM, generator=gen, device=dev).expand(16, 4, SEQ_DIM)
    same = same.contiguous()
    tie_items = torch.randn(3001, SEQ_DIM, generator=gen, device=dev)
    cases.append(check_multimax(same, tie_items, 3001, True, "all interests equal"))
    lse = mmce.multimax_lse(same, tie_items, 3001, True)
    du, _ = mmce.multimax_grads(same, tie_items, lse, 3001, True)
    if bool(du[:, 1:].any()) or not bool(du[:, 0].any()):
        raise RuntimeError("all interests equal: the gradient left the lowest interest")

    lse = mmce.multimax_lse(u, table, SEQ_VOCAB, True)
    t = {"fwd": median_ms([lambda: mmce.launch_lse(u, table, SEQ_VOCAB, True)], MM_LAUNCHES, 5),
         "bwd": median_ms([lambda: mmce.launch_grads(u, table, lse, SEQ_VOCAB, True)],
                          MM_LAUNCHES, 3),
         "plain_fwd": median_ms([lambda: mmce.multimax_lse_reference(u, table, SEQ_VOCAB, True)],
                                MM_LAUNCHES, 3),
         "plain_bwd": median_ms([lambda: mmce.multimax_grads_reference(u, table, lse, SEQ_VOCAB,
                                                                         True)], MM_LAUNCHES, 3)}
    flop = mm_work(SEQ_BATCH, 4, SEQ_DIM, SEQ_VOCAB)
    u_bytes, table_bytes, lse_bytes = u.numel() * 4, table.numel() * 4, SEQ_BATCH * 4
    out = []
    for name, work, moved, ms, plain_ms, replaces, errs in (
            ("multimax_ce", flop, u_bytes + table_bytes + lse_bytes, t["fwd"], t["plain_fwd"],
             "rec_pangu_tpu/ops/kernels/multimax_ce.py:72", ("lse",)),
            ("multimax_ce_bwd", mm_bwd_work(SEQ_BATCH, 4, SEQ_DIM, SEQ_VOCAB),
             2 * (u_bytes + table_bytes) + lse_bytes, t["bwd"],
             t["plain_bwd"], "rec_pangu_tpu/ops/kernels/multimax_ce.py:103",
             ("du", "d_items"))):
        by_ops, by_bytes = work / fp32 * 1e3, moved / bandwidth * 1e3
        out.append({
            "name": name, "route": "cuda", "source": "rec_pangu_tpu_torch/csrc/multimax_ce.cu",
            "replaces": replaces, "max_abs_err": max(c[e] for c in cases for e in errs),
            "tolerance": f"{'/'.join(errs)} within {MM_REL_TOL} of the array's largest entry; "
                         f"max_abs_err is that relative error",
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call computes the K-max CE",
            "bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "flop": work, "bytes": moved, "ops_bound_ms": by_ops, "bytes_bound_ms": by_bytes,
            "shape": {"B": SEQ_BATCH, "K": 4, "D": SEQ_DIM, "table_rows": rows,
                      "valid_items": SEQ_VOCAB, "zero_row0": True}})
    out[1].update({"cases": cases, "seconds": time.perf_counter() - t_start})
    return tuple(out)


def write_model_checkpoint(path: str, name: str, config: dict, seed: int) -> dict:
    """A checkpoint of the sequence model ``name`` in the JAX package's
    layout at full width: seeded weights (the port's init, which is the JAX
    package's, with small random biases and LayerNorm terms), the item table
    [padded_rows(1,000,000), 64]."""
    enc_dict = {"item_id": {"vocab_size": SEQ_VOCAB}}
    model = port.get_model(name)(enc_dict=enc_dict, config=config, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    save_checkpoint(path, jax_variables(model)["params"], None, enc_dict=enc_dict)
    return enc_dict


def phase_model_serving(path: str, enc_dict: dict, name: str, config: dict, kernels,
                        seed: int, device: str = "cuda"):
    """Retrieval by the sequence model ``name`` at full width from a
    JAX-layout checkpoint: SequenceTrainer.load_model, make_retrieval_scorer,
    1024 histories a request, top-200 of the whole L2-normalized corpus (a
    multi-interest model scores each item by its best interest), each of
    ``kernels`` once a request (IOCRec: K1 + K4f + K6f); two requests held
    against the CPU on their first IOC_CPU_USERS histories."""
    t_start = time.perf_counter()
    model = load_seq_model(path, enc_dict, device, name, config)
    retrieve = make_retrieval_scorer(model, topk=SEQ_TOPK, device=device)
    setup_s = time.perf_counter() - t_start
    requests = make_seq_requests(SEQ_WARMUP + SEQ_REQUESTS, seed)

    # the main path: every count is 0 just before it and read just after
    reset_launches()
    latencies = []
    for i, req in enumerate(requests):
        t0 = time.perf_counter()
        scores, ids = retrieve(req)
        if i >= SEQ_WARMUP:
            latencies.append(time.perf_counter() - t0)
        if (scores.shape != (SEQ_BATCH, SEQ_TOPK) or ids.shape != scores.shape
                or not np.all(np.isfinite(scores)) or bool((np.diff(scores, axis=1) > 0).any())
                or ids.min() < 1 or ids.max() >= SEQ_VOCAB):
            raise RuntimeError(f"bad {name} retrieval answer for request {i}")
    launches = read_launches()
    n = len(requests)
    phase = f"{name.lower()}_serving"
    require_launches(launches, {k: n for k in kernels}, phase)

    cpu_model = load_seq_model(path, enc_dict, "cpu", name, config)
    cpu_retrieve = make_retrieval_scorer(cpu_model, topk=SEQ_TOPK + 1, device="cpu")
    emb_err, differing = 0.0, 0
    for req in requests[:IOC_CPU_CHECKS]:
        part = {k: v[:IOC_CPU_USERS] for k, v in req.items()}
        scores, ids = retrieve(part)
        with torch.inference_mode():
            card_emb = model(model.upload_batch(part, torch.device(device)))["user_emb"]
            cpu_emb = cpu_model(cpu_model.upload_batch(part, torch.device("cpu")))["user_emb"]
        emb_err = max(emb_err, (card_emb.cpu() - cpu_emb).abs().max().item())
        cpu_scores, cpu_ids = cpu_retrieve(part)
        differing += compare_topk(ids, scores, cpu_ids, cpu_scores)
    if emb_err > USER_EMB_ATOL:
        raise RuntimeError(f"card {name} user_emb differs from the CPU's by {emb_err}")
    del cpu_model, cpu_retrieve

    summary = {
        "phase": phase, "model": name, "config": config, "vocab": SEQ_VOCAB,
        "table_rows": int(model.item_emb.table.shape[0]), "batch": SEQ_BATCH, "topk": SEQ_TOPK,
        "requests": SEQ_REQUESTS, "warmup": SEQ_WARMUP, "launches": launches,
        "launches_per_request": {k: v / n for k, v in launches.items() if v},
        "p50_ms": statistics.median(latencies) * 1e3,
        "p90_ms": float(np.percentile(latencies, 90)) * 1e3,
        "users_per_s": SEQ_REQUESTS * SEQ_BATCH / sum(latencies),
        "cpu_checked_requests": IOC_CPU_CHECKS, "cpu_checked_users": IOC_CPU_USERS,
        "user_emb_max_abs_err_vs_cpu": emb_err, "user_emb_atol": USER_EMB_ATOL,
        "score_atol": SCORE_ATOL,
        "topk_positions_compared": IOC_CPU_CHECKS * IOC_CPU_USERS * SEQ_TOPK,
        "topk_positions_differing_at_ties": differing,
        "setup_s": setup_s, "seconds": time.perf_counter() - t_start,
    }
    return summary, model, requests[SEQ_WARMUP:SEQ_WARMUP + SEQ_PROFILED]


def phase_model_training(path: str, enc_dict: dict, ckpt_dir: str, name: str, config: dict,
                         per_step, per_batch, seed: int, std_steps: int = 0,
                         epochs: int = FIT_EPOCHS, device: str = "cuda"):
    """SequenceTrainer.fit on the sequence model ``name`` at full width from
    the JAX-layout checkpoint: ``epochs`` of FIT_TRAIN_BATCHES bench-shape
    batches with the host keys the trainer attaches (IOCRec's and
    ContraRec's views, CLRec's lookup_all), FIT_VALID_BATCHES of
    validation, log.csv, checkpoints and early stopping, on the sequence
    fused step: each of ``per_step`` once a step, each of ``per_batch`` once
    a step and an eval batch (IOCRec: K1, K4f, K4b, K6f, K6b, K5f, K5b, K3).
    Then ``std_steps`` standard steps (K2 for K3)."""
    t_start = time.perf_counter()
    train_loader = seq_train_loader(FIT_TRAIN_BATCHES, seed)
    valid_loader = seq_valid_loader(FIT_VALID_BATCHES, seed + 1)
    model = load_seq_model(path, enc_dict, device, name, config)
    trainer = SequenceTrainer(device=device, model_ckpt_dir=ckpt_dir)
    setup_s = time.perf_counter() - t_start

    # the main path: every count is 0 just before it and read just after
    reset_launches()
    t0 = time.perf_counter()
    times, losses = timed_seq_fit(trainer, model, train_loader, valid_loader, epochs, device)
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    steps, evals = epochs * FIT_TRAIN_BATCHES, epochs * FIT_VALID_BATCHES
    require_launches(launches, {**{k: steps for k in per_step},
                                **{k: steps + evals for k in per_batch}}, f"{name} fused fit")
    if not trainer._train_step.fused:
        raise RuntimeError(f"{name}'s fit did not take the sequence fused step")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not (np.all(np.isfinite(losses)) and last < first):
        raise RuntimeError(f"the {name} training loss did not fall: {losses}")
    files = sorted(os.listdir(ckpt_dir))
    want = ({f"model_e_{i}.ckpt" for i in range(1, epochs + 1)}
            | {"model_best.ckpt", "log.csv"})
    if not want <= set(files):
        raise RuntimeError(f"fit's files missing: {sorted(want - set(files))} of {files}")
    del trainer, model
    summary = {
        "phase": f"{name.lower()}_training", "model": name, "config": config,
        "vocab": SEQ_VOCAB, "batch": SEQ_BATCH, "epochs": epochs,
        "steps_per_epoch": FIT_TRAIN_BATCHES, "valid_batches": FIT_VALID_BATCHES, "lr": LR,
        "launches": launches, "fused": step_stats(times, SEQ_BATCH), "fit_s": fit_s,
        "setup_s": setup_s, "loss_first3": first, "loss_last3": last, "losses": losses,
        "files": files,
    }
    if std_steps:  # the standard step: K2 for K3, torch.optim.Adam over the table
        loader = DataLoader(_SeqArrays({k: v[:std_steps * SEQ_BATCH] for k, v in
                                        train_loader.dataset.arrays.items()}),
                            batch_size=SEQ_BATCH)
        std_model = load_seq_model(path, enc_dict, device, name, config)
        std_trainer = SequenceTrainer(device=device, model_ckpt_dir=ckpt_dir)
        os.environ["REC_PANGU_TPU_FUSED_ADAM"] = "0"
        try:
            reset_launches()
            std_times, std_losses = timed_seq_fit(std_trainer, std_model, loader, None, 1,
                                                  device)
            std_launches = read_launches()
        finally:
            del os.environ["REC_PANGU_TPU_FUSED_ADAM"]
        require_launches(std_launches, {**{k: std_steps for k in per_step + per_batch},
                                        "fused_adam": 0, "embedding_grad": std_steps},
                         f"{name} standard fit")
        if std_trainer._train_step.fused or not np.all(np.isfinite(std_losses)):
            raise RuntimeError(f"the {name} standard step did not run cleanly: {std_losses}")
        summary.update({"standard_launches": std_launches,
                        "standard": step_stats(std_times, SEQ_BATCH),
                        "standard_losses": std_losses})
    summary["seconds"] = time.perf_counter() - t_start
    return summary, train_loader


def phase_iocrec_card_vs_cpu(devices=("cuda", "cpu")) -> dict:
    """The first three IOCRec fused steps on the card and on the CPU at a
    cut corpus (100,000 items, 128 histories), from the same weights,
    batches, host views and dropout seeds (the masks are the same hash on
    both): the first step's gradient of every leaf before Adam (the table's
    as the rows summed at their ids plus the CE's dense stream), losses,
    dense parameters and the table, at the fit's rate LR and at
    IOC_SMALL_LR.

    The local encoder's relu has a kink: a pre-activation within rounding
    of 0 takes derivative 1 on one side and 0 on the other (the K4b row
    holds the kernels apart from such samples), so the gradients of the
    leaves behind it (IOC_KINK_PATH) differ beyond rounding, held within
    IOC_KINK_GRAD_REL_TOL of each leaf's largest entry; every other leaf
    within IOC_GRAD_REL_TOL.  Adam's first steps, lr * g / (|g| + eps), move
    each entry by about lr whatever its size, so an entry near 0 may move
    by 2 lr apart (IOC_DENSE_HANDFUL of them).  The step-1 loss is held
    within IOC_LOSS_RTOL; at LR the later losses move apart by about lr
    times the loss's sensitivity, held within IOC_LATER_LOSS_RTOL; at
    IOC_SMALL_LR, ten times less, all three within IOC_LOSS_RTOL."""
    from rec_pangu_tpu_torch.models.sequence.augment import host_augment_sequences

    t_start = time.perf_counter()
    rng = np.random.default_rng(10_301)
    batches = []
    for batch in seq_train_loader(CPU_STEPS, SEED + 97, SEQ_CPU_VOCAB, IOC_CPU_BATCH):
        hist = batch["hist_item_list"]
        views = [host_augment_sequences(rng, hist, 3.0, 3.0, SEQ_CPU_VOCAB - 1)
                 for _ in range(2)]
        batches.append({**batch, "aug_all": np.concatenate([hist] + views)})
    summary = {"phase": "iocrec_card_vs_cpu", "steps": CPU_STEPS, "vocab": SEQ_CPU_VOCAB,
               "batch": IOC_CPU_BATCH, "dropout": IOC_DROP}
    for lr, later_rtol in ((LR, IOC_LATER_LOSS_RTOL), (IOC_SMALL_LR, IOC_LOSS_RTOL)):
        leg = card_vs_cpu_leg("IOCRec", IOC_CONFIG, batches, lr, devices, SEED + 94,
                              lambda k: k.startswith(IOC_KINK_PATH))
        summary[f"lr_{lr:g}"] = leg
        require_card_like_cpu(leg, later_rtol, IOC_KINK_GRAD_REL_TOL, summary)
    summary.update({"loss_rtol": IOC_LOSS_RTOL, "later_loss_rtol_at_lr": IOC_LATER_LOSS_RTOL,
                    "grad_rel_tol": IOC_GRAD_REL_TOL,
                    "kink_path_grad_rel_tol": IOC_KINK_GRAD_REL_TOL,
                    "dense_atol": SEQ_DENSE_ATOL, "dense_handful": IOC_DENSE_HANDFUL,
                    "table_atol": SEQ_TABLE_ATOL, "table_handful": SEQ_HANDFUL,
                    "seconds": time.perf_counter() - t_start})
    return summary


def require_card_like_cpu(leg: dict, later_rtol: float, kink_rel_tol: float,
                          summary: dict) -> None:
    """A card-against-CPU leg within its bounds: the step-1 loss within
    IOC_LOSS_RTOL and the later ones within ``later_rtol``; the first step's
    gradients within IOC_GRAD_REL_TOL of each leaf's largest entry
    (``kink_rel_tol`` on the relu's path, the exact zeros of their weight's);
    the parameters after one step: dense elements past SEQ_DENSE_ATOL at most
    IOC_DENSE_HANDFUL, table elements past SEQ_TABLE_ATOL at most
    SEQ_HANDFUL, none of either past 2 lr."""
    lr = leg["lr"]
    losses_ok = (leg["loss_rel_diffs"][0] <= IOC_LOSS_RTOL
                 and max(leg["loss_rel_diffs"]) <= later_rtol)
    grads_ok = (leg["grad_rel_err"] <= IOC_GRAD_REL_TOL
                and leg["kink_path_grad_rel_err"] <= kink_rel_tol
                and leg["zero_grad_rel_size"] <= IOC_GRAD_REL_TOL)
    if (not losses_ok or not grads_ok
            or leg["dense_elements_beyond_atol"] > IOC_DENSE_HANDFUL
            or leg["dense_max_abs_diff"] > 2 * lr
            or leg["table_elements_beyond_atol"] > SEQ_HANDFUL
            or leg["table_max_abs_diff"] > 2 * lr):
        raise RuntimeError(f"the card's training differs from the CPU's: {summary}")


@contextlib.contextmanager
def recording_table_grad(out: list):
    """Within it, the sequence fused step appends each step's table
    gradient (the captured rows summed at their ids plus the CE's dense
    stream), on the CPU, to ``out`` before its table update."""
    from rec_pangu_tpu_torch.train import fused_update

    update = fused_update.planned_adam_update

    def record(ids, rows, table, mu, nu, hyper, dense=None):
        grad = torch.zeros_like(table) if dense is None else dense.clone()
        out.append(grad.index_add_(0, ids.long(), rows).cpu())
        return update(ids, rows, table, mu, nu, hyper, dense)

    fused_update.planned_adam_update = record
    try:
        yield
    finally:
        fused_update.planned_adam_update = update


def grad_comparison(card: dict, cpu: dict, on_kink_path) -> dict:
    """The first step's gradients, card against CPU, leaf by leaf: each
    within a share of its own largest entry, those ``on_kink_path`` (a
    relu's derivative lies between them and the loss) apart; the exact zeros
    (IOC_ZERO_GRAD) are rounding noise on both sides, held as a share of
    their weight's largest gradient (the LayerNorm's scale, the dense
    kernel's)."""
    if set(card) != set(cpu):
        raise RuntimeError(f"the card and the CPU give gradients to different leaves: "
                           f"{sorted(set(card) ^ set(cpu))}")
    errs, zero = {}, {}
    for k, want in cpu.items():
        if k.endswith(IOC_ZERO_GRAD):
            base = k[:-len("bias")]
            scale = cpu[base + "kernel"] if base + "kernel" in cpu else cpu[base + "weight"]
            zero[k] = max(card[k].abs().max().item(), want.abs().max().item()) / (
                scale.abs().max().item())
        else:
            errs[k] = rel_err(card[k], want)
    kink = {k: v for k, v in errs.items() if on_kink_path(k)}
    rest = {k: v for k, v in errs.items() if k not in kink}
    worst = max(rest, key=rest.get)
    worst_kink = max(kink, key=kink.get, default=None)
    return {"grad_rel_err": rest[worst], "grad_worst_leaf": worst,
            "kink_path_grad_rel_err": kink.get(worst_kink, 0.0),
            "kink_path_worst_leaf": worst_kink,
            "zero_grad_rel_size": max(zero.values()), "grad_leaves": len(errs),
            "grad_rel_err_by_leaf": errs, "zero_grad_rel_size_by_leaf": zero}


def card_vs_cpu_leg(name: str, config: dict, batches, lr: float, devices, seed: int,
                    on_kink_path) -> dict:
    """Three fused steps of the model ``name`` (SEQ_CPU_VOCAB items, weights
    from ``seed``) at ``lr`` on each device, from host ``batches`` that
    already hold the model's host keys; what differs."""
    from rec_pangu_tpu_torch.train.fused_update import maybe_enable_seq_fused_update

    enc_dict = {"item_id": {"vocab_size": SEQ_CPU_VOCAB}}
    runs = {}
    for dev in devices:
        model = port.get_model(name)(enc_dict=enc_dict, config=config, seed=seed)
        model = model.to(dev).train()
        step = maybe_enable_seq_fused_update(model, lr, CPU_STEPS,
                                             generator=torch.Generator().manual_seed(SEED))
        losses, table_grads = [], []
        with recording_table_grad(table_grads):
            for i, batch in enumerate(batches):
                out = step(model.upload_batch(batch, torch.device(dev), train=True), i)
                losses.append(float(out["loss"].detach()))
                if i == 0:  # the step leaves each dense leaf's gradient in .grad
                    grads = {k: p.grad.detach().cpu().clone()
                             for k, p in model.named_parameters() if p.grad is not None}
                    grads["item_emb.table"] = table_grads[0]
                    after_one = {k: v.detach().cpu().clone()
                                 for k, v in model.state_dict().items()}
        runs[dev] = (losses, grads, after_one)
    (card_losses, card_grads, card), (cpu_losses, cpu_grads, cpu) = (runs[d] for d in devices)
    diffs = {k: (card[k] - cpu[k]).abs() for k in cpu}
    table_key = "item_emb.table"
    # the exact zeros (IOC_ZERO_GRAD) hold rounding noise on both sides,
    # which Adam's first step turns into +-lr
    zero = [k for k in cpu if k.endswith(IOC_ZERO_GRAD)]
    dense = torch.cat([d.reshape(-1) for k, d in diffs.items()
                       if k != table_key and k not in zero])
    table = diffs[table_key]
    return {"lr": lr, "card_losses": card_losses, "cpu_losses": cpu_losses,
            "loss_rel_diffs": [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)],
            **grad_comparison(card_grads, cpu_grads, on_kink_path),
            "dense_max_abs_diff": dense.max().item(),
            "dense_elements_beyond_atol": int((dense > SEQ_DENSE_ATOL).sum().item()),
            "dense_elements": dense.numel(),
            "zero_grad_max_abs_diff": max(diffs[k].max().item() for k in zero),
            "table_max_abs_diff": table.max().item(),
            "table_elements_beyond_atol": int((table > SEQ_TABLE_ATOL).sum().item()),
            "table_elements": table.numel()}


# ------------------------------------------------------ ContraRec and CLRec
# at bench.py's sequence width with the JAX classes' own defaults
# (rec_pangu_tpu/models/sequence/{contrarec,clrec}.py): the BERT4Rec
# encoder (2 blocks of 2 heads, relu FFN of 64, LayerNorm eps 1e-5, no
# dropout, bidirectional over each history's first `length` positions);
# ContraRec's gamma 1, Beta(3, 3) views and ccc_temp 0.2; CLRec's temp 0.1
CONTRA_CONFIG = {"embedding_dim": SEQ_DIM, "max_length": SEQ_L, "gamma": 1, "beta_a": 3,
                 "beta_b": 3, "ccc_temp": 0.2, "encoder_name": "BERT4Rec", "item_col": "item_id"}
CLREC_CONFIG = {"embedding_dim": SEQ_DIM, "max_length": SEQ_L, "temp": 0.1,
                "item_col": "item_id"}
BERT_KERNELS = ("embedding_lookup", "fused_encoder")     # once a request, step and eval batch
BERT_STEP_KERNELS = ("fused_adam", "fused_encoder_bwd")  # once a fused step
CONTRA_EPOCHS = 2          # fit epochs: random targets are learnt only when seen again
AUG_STEPS = 8              # ContraRec standard steps on device views (K7's path), over
                           # AUG_STEPS / 2 batches twice
SORTED_ID_SETS = 4         # K7 row: id batches a timing graph cycles through
CONTRA_PROFILED = 4        # fused steps traced by the profiler


def device_view_ids(gen, seed: int) -> torch.Tensor:
    """The ids of ContraRec's device-branch lookup: a bench batch of
    histories and its two views drawn on the card (``augment_sequences``,
    the model's own draw), [3 * SEQ_BATCH * SEQ_L] int32."""
    from rec_pangu_tpu_torch.models.sequence.augment import augment_sequences

    hist = torch.from_numpy(seq_train_loader(1, seed).dataset.arrays["hist_item_list"])
    hist = hist.to(gen.device)
    views = [augment_sequences(gen, hist, 3.0, 3.0, SEQ_VOCAB - 1) for _ in range(2)]
    return torch.cat([hist] + views).reshape(-1)


def seq_skewed_ids(num_rows: int, dev) -> dict:
    """Ids at K7's shape with long runs of equal ids: every id equal, and
    histories whose first positions take few values (LOW_CARD) and the rest
    Zipf over the items."""
    n = 3 * SEQ_BATCH
    rng = np.random.default_rng(SEED + 31)
    cols = [rng.integers(1, c + 1, n) for c in LOW_CARD]
    cols += [np.minimum(rng.zipf(ZIPF_A, n), SEQ_VOCAB - 1) for _ in range(SEQ_L - len(LOW_CARD))]
    ids = torch.from_numpy(np.stack(cols, 1).astype(np.int32)).reshape(-1).to(dev)
    return {"all_equal": torch.full((n * SEQ_L,), num_rows // 2, dtype=torch.int32, device=dev),
            "low_card_zipf": ids}


def phase_sorted_accumulate(bandwidth: float) -> dict:
    """K7's counterpart (``embedding_grad.sorted_segment_accumulate``: the
    sort on the card, then the table gradient kernel) at its call-site
    shape: ContraRec's device-branch lookup, 3 x 1024 histories of 50 over
    the [1,007,616, 64] table, against index_add_ on the card, within the
    rounding bound of ``sum_tolerance`` and twice for the same bits; also at
    all-equal and low-cardinality/Zipf ids."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 100)
    num_rows = padded_rows(SEQ_VOCAB)
    id_sets = [device_view_ids(gen, SEED + 101 + i) for i in range(SORTED_ID_SETS)]
    ids = id_sets[0]
    cot = torch.randn(ids.numel(), SEQ_DIM, generator=gen, device=dev) * 1e-3
    accumulate = grad.sorted_segment_accumulate
    out = accumulate(ids, cot, num_rows)
    require_equal(accumulate(ids, cot, num_rows), out, "K7 shape, run twice")
    bound, hits = sum_tolerance(ids, cot, num_rows)
    max_abs_err = require_within(out, grad.table_grad_reference(ids, cot, num_rows), bound,
                                 f"K7 shape [{num_rows}, {SEQ_DIM}] x {ids.numel()} ids")
    skewed = {}
    for kind, x in seq_skewed_ids(num_rows, dev).items():
        got = accumulate(x, cot, num_rows)
        require_equal(accumulate(x, cot, num_rows), got, f"K7 shape {kind}, run twice")
        x_bound, x_hits = sum_tolerance(x, cot, num_rows)
        require_within(got, grad.table_grad_reference(x, cot, num_rows), x_bound,
                       f"K7 shape, {kind}")
        skewed[kind] = {"max_hits_per_row": int(x_hits.max().item()), "ms": median_ms(
            [lambda: accumulate(x, cot, num_rows)], SKEW_LAUNCHES)}

    n = ids.numel()
    moved = num_rows * SEQ_DIM * 4 + n * SEQ_DIM * 4 + n * 4  # grad written; rows, ids read
    sorted_sets = [grad.sort_ids(x) for x in id_sets]
    long_sets = [x.long() for x in id_sets]
    lib = torch.zeros(num_rows, SEQ_DIM, device=dev)
    return {
        "name": "embedding_grad_sorted", "route": "cuda",
        "source": "rec_pangu_tpu_torch/csrc/embedding_grad.cu",
        "replaces": "rec_pangu_tpu/ops/kernels/embedding_grad.py:67",
        "max_abs_err": max_abs_err,
        "tolerance": "per element 2(k-1)*2^-24*sum|x| over its k terms (sum order)",
        "ids": n, "table_rows": num_rows, "max_hits_per_row": int(hits.max().item()),
        "ms": median_ms([lambda x=x: accumulate(x, cot, num_rows) for x in id_sets]),
        "kernel_only_ms": median_ms([lambda s=s: grad.launch(*s, cot, num_rows)
                                     for s in sorted_sets]),
        "sort_ms": median_ms([lambda x=x: grad.sort_ids(x) for x in id_sets]),
        "plain_ms": median_ms([lambda x=x: grad.table_grad_reference(x, cot, num_rows)
                               for x in id_sets]),
        "bound_ms": moved / bandwidth * 1e3, "bound_by": "bytes",
        "library_ms": median_ms([lambda x=x: lib.zero_().index_add_(0, x, cot)
                                 for x in long_sets]),
        "library": "torch.zeros(V, D).index_add_(0, ids, rows) (atomics)",
        "bytes": moved, "skewed": skewed,
    }


def phase_device_aug(path: str, enc_dict: dict, device: str = "cuda") -> dict:
    """K7's path: ContraRec standard steps (``train/steps.StandardStep``) on
    bench batches uploaded without ``aug_all``, so that each forward draws
    the two views on the card from the step's seed and looks up [hist; v1;
    v2] [3072, 50] in one lookup no step captures.  Its backward is the
    table gradient over 153,600 ids sorted on the card, once a step, beside
    K1, K4f and K4b; no K3.  The loss must be finite and fall over two
    passes of the batches (new views each time)."""
    from rec_pangu_tpu_torch.train.steps import StandardStep

    t_start = time.perf_counter()
    batches = list(seq_train_loader(AUG_STEPS // 2, SEED + 120)) * 2
    model = load_seq_model(path, enc_dict, device, "ContraRec", CONTRA_CONFIG).train()
    step = StandardStep(model, LR, AUG_STEPS, generator=torch.Generator().manual_seed(SEED))
    dev = torch.device(device)
    setup_s = time.perf_counter() - t_start

    # the main path: every count is 0 just before it and read just after
    reset_launches()
    times, losses = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        out = step(model.upload_batch(batch, dev, train=True), i)
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(out["loss"].detach())
    launches = read_launches()
    require_launches(launches, {k: AUG_STEPS for k in ("embedding_lookup", "fused_encoder",
                                                       "fused_encoder_bwd", "embedding_grad")},
                     "contrarec_device_aug")
    losses = [float(x) for x in losses]
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not (np.all(np.isfinite(losses)) and last < first):
        raise RuntimeError(f"the device-view training loss did not fall: {losses}")
    return {"phase": "contrarec_device_aug", "model": "ContraRec", "config": CONTRA_CONFIG,
            "vocab": SEQ_VOCAB, "batch": SEQ_BATCH, "lookup_ids_per_step": 3 * SEQ_BATCH * SEQ_L,
            "lr": LR, "launches": launches, "standard": step_stats(times, SEQ_BATCH),
            "loss_first3": first, "loss_last3": last, "losses": losses, "setup_s": setup_s,
            "seconds": time.perf_counter() - t_start}


def phase_contrastive_card_vs_cpu(name: str, config: dict, devices=("cuda", "cpu")) -> dict:
    """The first three fused steps of ContraRec or CLRec on the card and on
    the CPU at a cut corpus (SEQ_CPU_VOCAB items, IOC_CPU_BATCH histories),
    from the same weights and batches, their host keys (ContraRec's views,
    CLRec's lookup_all) made by a trainer's hooks as fit makes them: the
    first step's gradient of every leaf before Adam, the losses, the
    parameters after one step, held by ``require_card_like_cpu``.  Every
    leaf's gradient within IOC_GRAD_REL_TOL of its largest entry, those
    behind the encoder's relu too: no sample of these inputs lies at its
    kink (first run: 1.9e-6 at most; see phase_iocrec_card_vs_cpu)."""
    t_start = time.perf_counter()
    trainer = SequenceTrainer(device="cpu")
    trainer.model = port.get_model(name)(enc_dict={"item_id": {"vocab_size": SEQ_CPU_VOCAB}},
                                         config=config)
    batches = [trainer._attach_host_keys(b) for b in
               seq_train_loader(CPU_STEPS, SEED + 130, SEQ_CPU_VOCAB, IOC_CPU_BATCH)]
    leg = card_vs_cpu_leg(name, config, batches, LR, devices, SEED + 131, lambda k: False)
    summary = {"phase": f"{name.lower()}_card_vs_cpu", "steps": CPU_STEPS,
               "vocab": SEQ_CPU_VOCAB, "batch": IOC_CPU_BATCH, f"lr_{LR:g}": leg,
               "loss_rtol": IOC_LOSS_RTOL, "later_loss_rtol": IOC_LATER_LOSS_RTOL,
               "grad_rel_tol": IOC_GRAD_REL_TOL,
               "dense_atol": SEQ_DENSE_ATOL, "dense_handful": IOC_DENSE_HANDFUL,
               "table_atol": SEQ_TABLE_ATOL, "table_handful": SEQ_HANDFUL}
    require_card_like_cpu(leg, IOC_LATER_LOSS_RTOL, IOC_GRAD_REL_TOL, summary)
    summary["seconds"] = time.perf_counter() - t_start
    return summary


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

    bandwidth, fp32 = peak_bandwidth(kind), peak_fp32(kind)
    rows = [phase_kernel(bandwidth), phase_table_grad(bandwidth),
            phase_sorted_accumulate(bandwidth), phase_fused_adam(bandwidth),
            phase_fused_encoder(bandwidth, fp32), phase_fused_encoder_bwd(bandwidth, fp32),
            *phase_global_attn(bandwidth, fp32), *phase_multimax_ce(bandwidth, fp32)]
    for row in rows:
        emit({"phase": "kernel", **row})
    torch.cuda.empty_cache()

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
        del trainer, train_loader, batches
        shutil.rmtree(os.path.join(tmp, "ckpt"))

        t0 = time.perf_counter()
        seq_path = os.path.join(tmp, "sasrec.ckpt")
        seq_enc_dict = write_seq_checkpoint(seq_path)
        emit({"phase": "seq_checkpoint", "seconds": time.perf_counter() - t0,
              "bytes": os.path.getsize(seq_path)})
        seq_serving, seq_model, seq_profiled = phase_seq_serving(seq_path, seq_enc_dict)
        emit(seq_serving)
        emit(phase_seq_profile(seq_model, seq_profiled))
        del seq_model
        emit(phase_seq_eval())
        emit(phase_seq_ce(fp32))
        torch.cuda.empty_cache()
        seq_training, seq_loader = phase_seq_training(seq_path, seq_enc_dict,
                                                      os.path.join(tmp, "seq_ckpt"))
        emit(seq_training)
        emit(phase_seq_card_vs_cpu())
        seq_batches = [b for _, b in zip(range(SEQ_TRAIN_PROFILED), seq_loader)]
        emit(phase_seq_train_profile(seq_path, seq_enc_dict, seq_batches,
                                     os.path.join(tmp, "seq_ckpt")))
        del seq_loader, seq_batches
        shutil.rmtree(os.path.join(tmp, "seq_ckpt"))
        os.remove(seq_path)
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ioc_path = os.path.join(tmp, "iocrec.ckpt")
        ioc_enc_dict = write_model_checkpoint(ioc_path, "IOCRec", IOC_CONFIG, SEED + 90)
        emit({"phase": "iocrec_checkpoint", "seconds": time.perf_counter() - t0,
              "bytes": os.path.getsize(ioc_path)})
        ioc_kernels = ("embedding_lookup", "fused_encoder", "global_attn")
        ioc_serving, ioc_model, ioc_profiled = phase_model_serving(
            ioc_path, ioc_enc_dict, "IOCRec", IOC_CONFIG, ioc_kernels, SEED + 96)
        emit(ioc_serving)
        emit(phase_seq_profile(ioc_model, ioc_profiled, "iocrec_profile"))
        del ioc_model
        torch.cuda.empty_cache()
        emit(phase_seq_eval("cuda", "IOCRec", IOC_CONFIG, ioc_kernels))
        ioc_training, ioc_loader = phase_model_training(
            ioc_path, ioc_enc_dict, os.path.join(tmp, "ioc_ckpt"), "IOCRec", IOC_CONFIG,
            ("fused_adam", "fused_encoder_bwd", "global_attn_bwd", "multimax_ce",
             "multimax_ce_bwd"), ioc_kernels, SEED + 92, IOC_STD_STEPS)
        emit(ioc_training)
        torch.cuda.empty_cache()
        emit(phase_iocrec_card_vs_cpu())
        ioc_batches = [b for _, b in zip(range(IOC_PROFILED), ioc_loader)]
        emit(phase_seq_train_profile(ioc_path, ioc_enc_dict, ioc_batches,
                                     os.path.join(tmp, "ioc_ckpt"),
                                     functools.partial(load_seq_model, name="IOCRec",
                                                       config=IOC_CONFIG),
                                     "iocrec_train_profile"))
        del ioc_loader, ioc_batches
        shutil.rmtree(os.path.join(tmp, "ioc_ckpt"))
        os.remove(ioc_path)
        torch.cuda.empty_cache()

        contrastive = {}
        for name, config, seed in (("ContraRec", CONTRA_CONFIG, SEED + 110),
                                   ("CLRec", CLREC_CONFIG, SEED + 140)):
            t0 = time.perf_counter()
            m_path = os.path.join(tmp, f"{name.lower()}.ckpt")
            m_enc_dict = write_model_checkpoint(m_path, name, config, seed)
            emit({"phase": f"{name.lower()}_checkpoint", "seconds": time.perf_counter() - t0,
                  "bytes": os.path.getsize(m_path)})
            m_serving, m_model, m_profiled = phase_model_serving(
                m_path, m_enc_dict, name, config, BERT_KERNELS, seed + 2)
            emit(m_serving)
            emit(phase_seq_profile(m_model, m_profiled, f"{name.lower()}_profile"))
            del m_model
            torch.cuda.empty_cache()
            emit(phase_seq_eval("cuda", name, config))
            m_ckpt = os.path.join(tmp, f"{name.lower()}_ckpt")
            m_training, m_loader = phase_model_training(
                m_path, m_enc_dict, m_ckpt, name, config, BERT_STEP_KERNELS, BERT_KERNELS,
                seed + 3, epochs=CONTRA_EPOCHS)
            emit(m_training)
            contrastive[name] = m_training
            torch.cuda.empty_cache()
            if name == "ContraRec":
                device_aug = phase_device_aug(m_path, m_enc_dict)
                emit(device_aug)
                torch.cuda.empty_cache()
            emit(phase_contrastive_card_vs_cpu(name, config))
            m_batches = [b for _, b in zip(range(CONTRA_PROFILED), m_loader)]
            emit(phase_seq_train_profile(
                m_path, m_enc_dict, m_batches, m_ckpt,
                functools.partial(load_seq_model, name=name, config=config),
                f"{name.lower()}_train_profile"))
            del m_loader, m_batches
            shutil.rmtree(m_ckpt)
            os.remove(m_path)
            torch.cuda.empty_cache()

    # launches on each kernel's own main path: the lookup's on serving, the
    # fused Adam's on the fused fit (and on the sequence fused fit), the
    # gradient's on the standard-step fit, the encoder's on SASRec serving,
    # its backward's on the sequence fused fit, the global attention's on
    # IOCRec serving, its backward's and the K-max CE's on IOCRec's fused
    # fit, the device-sorted gradient's (K7) on ContraRec's device views
    launches = {"embedding_lookup": serving["launches"]["embedding_lookup"],
                "fused_adam": training["launches"]["fused_adam"],
                "embedding_grad": training["standard_launches"]["embedding_grad"],
                "embedding_grad_sorted": device_aug["launches"]["embedding_grad"],
                "fused_encoder": seq_serving["launches"]["fused_encoder"],
                "fused_encoder_bwd": seq_training["launches"]["fused_encoder_bwd"],
                "global_attn": ioc_serving["launches"]["global_attn"],
                **{k: ioc_training["launches"][k]
                   for k in ("global_attn_bwd", "multimax_ce", "multimax_ce_bwd")}}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    lines = [{k: launches[row["name"]] if k == "launches" else row[k] for k in keys}
             for row in rows]
    for line in lines:
        if line["name"] in ("fused_adam", "fused_encoder"):
            line["launches_seq_training"] = seq_training["launches"][line["name"]]
        if line["name"] in ("embedding_lookup", "fused_adam", "fused_encoder",
                            "fused_encoder_bwd", "global_attn"):
            line["launches_iocrec_training"] = ioc_training["launches"][line["name"]]
        if line["name"] in BERT_KERNELS + BERT_STEP_KERNELS:
            for name, m_training in contrastive.items():
                line[f"launches_{name.lower()}_training"] = m_training["launches"][line["name"]]
    emit({"kernels": lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
