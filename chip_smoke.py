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
               card (``phase_sorted_accumulate``); with both, the radix
               sort (``sort_ids``) equal to its plain version (a stable
               torch.sort of the clamped ids) at their shapes, edge shapes
               and tables of 1 to 4 passes (``check_sorts``), and the
               gradient's parts timed alone (``table_grad_parts``); the fused
               encoder (K4f) within the tolerances at ``check_encoder``; its
               backward (K4b) and dropout forward against the plain version's
               autograd with the same dropout masks, within the tolerances at
               ``check_encoder_bwd``, the forward's saved activations and
               each launch of K4b against its stage's plain version
               (``check_encoder_bwd_stages``), each launch timed alone
               (``encoder_bwd_parts``), and the masks' seed and keep share;
               the K-max CE (K5f, K5b) and each of K5b's launches against
               its stage's plain version (``check_multimax_stages``).
3b. kernel_d1, kernel_d40 -- K3 and K2 at the LR table's shape ([1,605,632,
               1], the 131,072 ids of a batch), and K1, K2 and K3 at the
               multi-task family's width ([1,605,632, 40]), against their
               plain versions, timed; K3 also alone on presorted ids and,
               at D = 1, WDL's two tables on one sort against one sort a
               table (``wdl_shared_sort``).  Every K3 row has its tile
               plan, its time alone and its share of the bound.
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
8b. wdl_*, lr_*, fm_*, nfm_*, dcn_*, xdeepfm_*, autoint_*, fibinet_*,
               masknet_*, afm_*, ccpm_*, aoanet_*, afn_* -- the ranking zoo
               at the same width with each JAX class's defaults:
               checkpoint, serving, a fit on the fused step (K1 a table a
               request, step and eval batch; K3 a table a step) and three
               fused steps card against CPU with the MLPs' dropout on; WDL
               also its profiles, validation, standard steps (K2 a table a
               step) and the full-width card_vs_cpu.
8c. mmoe_*, sharebottom_*, essm_*, omoe_*, mlmmoe_*, aitm_* -- the
               multi-task zoo at the same width with each JAX class's
               defaults (D = 40, AITM 32; two tasks): checkpoint, serving
               through RankTrainer(num_task=2)._predict (K1 a request),
               evaluate_model's per-task metrics, a fit on the fused step
               (asserted) and three fused steps card against CPU with the
               towers' dropout on; MMOE (bench.py's leg) also its profiles,
               validation, standard steps (K2) and the card_vs_cpu at full
               width.
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
19. gru4rec_*, yotubednn_*, narm_*, stamp_*, nextitnet_* -- the classic
               sequence models at the same width with their own defaults
               (K1 a request, step and eval batch, K3 a fused step; no
               transformer): checkpoint, serving, eval, training (fit, 2
               epochs on the fused step), card_vs_cpu with cuDNN's TF32 at
               torch's default; GRU4Rec also profile, standard steps (K2),
               train_profile and gru (the GRU's forward and backward alone).
20. contrarec_gru4rec_*, contrarec_caser_* -- ContraRec with its GRU4Rec
               and Caser encoders: checkpoint, serving, training (fit on
               the host views) and device_aug (standard steps on device
               views: K7's path).
20b. srgnn_*, gcsan_*, niser_* -- the session-graph family at the same
               width (SRGNN is bench.py's leg): checkpoint, retrieval
               serving (the graph built on the card; K1 of the nodes a
               request, GCSAN's K4f too), eval, a fit on the sequence fused
               step (asserted; the trainer's host graph: K3's ids are the
               nodes; GCSAN's K4b too), card_vs_cpu; SRGNN also whole
               requests against the CPU, profiles and standard steps (K2).
21. past_limits -- SASRec at max_len 100 and at hidden size 256, IOCRec with
               K = 8 and at max_len 80: retrieval and two fused steps each,
               card against CPU, on the plain versions of the kernels whose
               limits they pass (0 launches of those; their plain-route
               counts).

Then the kernels line, the card's name and power limit as nvidia-smi gives
them, and last {"ok": true, "device": {...}}.

Float32 matmuls are held to full precision for the comparisons:
torch.backends.cuda.matmul.allow_tf32 = False (and the cuDNN flag too),
except in the classic models' card_vs_cpu phases, which restore both flags
to torch's defaults: the port's convolutions and GRU are products that no
cuDNN switch reaches.
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
from rec_pangu_tpu_torch.ops.kernels import encoder_bwd as ebwd
from rec_pangu_tpu_torch.ops.kernels import fused_adam as adam
from rec_pangu_tpu_torch.ops.kernels import fused_encoder as encoder
from rec_pangu_tpu_torch.ops.kernels import global_attn as gattn
from rec_pangu_tpu_torch.ops.kernels import multimax_ce as mmce
from rec_pangu_tpu_torch.ops.sequence_enc import TransformerEncoder
from rec_pangu_tpu_torch.serving import make_ranking_scorer, make_retrieval_scorer
from rec_pangu_tpu_torch.serving.scorer import score_items
from rec_pangu_tpu_torch.convert import jax_variables
from rec_pangu_tpu_torch.models.multi_task import OMOE
from rec_pangu_tpu_torch.models.multi_task.common import TaskTower
from rec_pangu_tpu_torch.train import RankTrainer, SequenceTrainer, save_checkpoint
from rec_pangu_tpu_torch.train.fused_update import fused_tables, maybe_enable_fused_update

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
ADAM_EDGE_DIMS = (1, 3, 8, 40, 64, 128)  # K3's edge widths (1, 3, 40: float4s across rows)

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
# data-sheet dense TF32 tensor-core rate (FLOP/s)
_TF32_PEAK = (("H100 PCIe", 378e12), ("H100 NVL", 417.5e12), ("H200", 495e12),
              ("H100", 495e12))


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


def peak_tf32(name: str) -> float:
    return _lookup_rate(_TF32_PEAK, name, "TF32 tensor-core rate")


def sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


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


# tables whose keys need 1, 2, 3 and 4 radix passes (sort_plan), each at
# the last size before the key bits grow and the first after
SORT_PASS_ROWS = (1, 2, 254, 255, 2 ** 16 - 2, 2 ** 16 - 1, 2 ** 24 - 2, 2 ** 24 - 1, 2 ** 31 - 1)


def check_sorts(cases: dict) -> list:
    """The radix sort (``sort_ids``) against its plain version on the card,
    (sorted ids, perm) equal, for each name -> (ids, num_rows)."""
    for name, (ids, num_rows) in cases.items():
        got = grad.sort_ids(ids, num_rows)
        want = grad.sort_ids_reference(ids, num_rows)
        for g, w, what in zip(got, want, ("sorted ids", "perm")):
            require_equal(g, w, f"sort {name} ({ids.numel()} ids, {num_rows} rows): {what}")
    return sorted(cases)


def pass_sort_cases(gen) -> dict:
    """Sort cases at SORT_PASS_ROWS: bench-many ids past both ends of each
    table, and 20 of them; then ids over the whole int32 range."""
    n, dev = BATCH * FIELDS, gen.device
    cases = {}
    for rows in SORT_PASS_ROWS:
        hi = min(rows + 50, 2 ** 31 - 1)
        ids = torch.randint(-50, hi, (n,), generator=gen, device=dev, dtype=torch.int32)
        cases[f"rows={rows},passes={grad.sort_plan(rows)[2]}"] = (ids, rows)
        cases[f"rows={rows},20 ids"] = (ids[:20], rows)
    wide = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    cases["int32 range,bench rows"] = (wide, padded_rows(FIELDS * (VOCAB + 1)))
    cases["int32 range,2^31-1 rows"] = (wide, 2 ** 31 - 1)
    return cases


def table_grad_parts(id_sets, cot, num_rows: int) -> dict:
    """The parts of the table gradient's path, each alone at one shape,
    median_ms over the id sets: the radix sort, the parent's prep it
    replaced (torch.sort and a cast), the kernel alone on presorted ids
    (``launch``: a mark pass, then the masked fill beside the levels), and
    its two halves: the zero fill of the unmarked rows and the levels (with
    a memset of their counts, which the whole path folds into the sort's).
    ``scripts/torch_table_grad.py --variants`` times the other orders."""
    fns = grad._functions(cot.device)
    dev, dim = cot.device, cot.shape[1]

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def old_sort(x):
        sorted_ids, perm = torch.sort(x, stable=True)
        return sorted_ids, perm.to(torch.int32)

    sorted_sets = [grad.sort_ids(x, num_rows) for x in id_sets]
    marks = [torch.empty((num_rows + 31) // 32, dtype=torch.int32, device=dev) for _ in id_sets]
    for x, m in zip(id_sets, marks):
        grad._check_launch(fns.mark_rows(x.data_ptr(), x.numel(), num_rows, m.data_ptr(),
                                         m.numel(), stream()), "row marks")
    out = torch.empty(num_rows, dim, device=dev)

    def fill(m):
        grad._check_launch(fns.fill_unmarked(out.data_ptr(), num_rows, dim, m.data_ptr(),
                                             stream()), "zero fill")

    return {
        "sort": median_ms([lambda x=x: grad.sort_ids(x, num_rows) for x in id_sets]),
        "torch_sort": median_ms([lambda x=x: old_sort(x) for x in id_sets]),
        "kernel_only": median_ms([lambda s=s: grad.launch(*s, cot, num_rows)
                                  for s in sorted_sets]),
        "masked_fill": median_ms([lambda m=m: fill(m) for m in marks]),
        "levels": median_ms([lambda s=s: grad._levels(*s, cot, out, stream())
                             for s in sorted_sets]),
    }


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

    sorts = check_sorts({
        **{f"bench {i}": (x, num_rows) for i, x in enumerate(id_sets)},
        **{f"edge {kind}": (edge_ids(kind, 5000, EDGE_ROWS, gen), EDGE_ROWS)
           for kind in EDGE_KINDS},
        **{f"bench {kind}": (x, num_rows)
           for kind, x in skewed_id_sets(num_rows, cot.device).items()},
        **pass_sort_cases(gen)})

    n = ids.numel()
    moved = num_rows * DIM * 4 + n * DIM * 4 + n * 4  # grad written; rows, ids read
    long_sets = [x.long() for x in id_sets]
    lib = torch.zeros(num_rows, DIM, device="cuda")
    row = {
        "name": "embedding_grad", "route": "cuda",
        "source": "rec_pangu_tpu_torch/csrc/embedding_grad.cu",
        "replaces": "rec_pangu_tpu/ops/kernels/embedding_grad.py:493",
        "max_abs_err": max_abs_err,
        "tolerance": "per element 2(k-1)*2^-24*sum|x| over its k terms (sum order)",
        "max_hits_per_row": int(hits.max().item()),
        "ms": median_ms([lambda x=x: grad.table_grad(x, cot, num_rows) for x in id_sets]),
        "plain_ms": median_ms([lambda x=x: grad.table_grad_reference(x, cot, num_rows)
                               for x in id_sets]),
        "bound_ms": moved / bandwidth * 1e3, "bound_by": "bytes",
        "library_ms": median_ms([lambda x=x: lib.zero_().index_add_(0, x, cot)
                                 for x in long_sets]),
        "library": "torch.zeros(V, D).index_add_(0, ids, rows) (atomics)",
        "call_ms": call_ms(lambda: grad.table_grad(ids, cot, num_rows)),
        "bytes": moved, "edge_cases": edges, "skewed": skewed, "sort_cases": sorts,
    }
    return with_parts(row, table_grad_parts(id_sets, cot, num_rows))


def with_parts(row: dict, parts: dict) -> dict:
    """A table-gradient row with its parts (``table_grad_parts``): the sort's
    times, the kernel alone, and the shares of the bound and the library
    call in ``ms``."""
    return {**row, "sort_ms": parts["sort"], "torch_sort_ms": parts["torch_sort"],
            "kernel_only_ms": parts["kernel_only"],
            "bound_share": row["bound_ms"] / row["ms"],
            "library_share": row["library_ms"] / row["ms"], "parts": parts}


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
        sorted_sets = [adam.sort_for(x, num_rows) for x in hist]
        out[key] = {
            "ms": median_ms([lambda x=x: adam.planned_adam_update(x, cot, p, m, v, hyper, dense)
                             for x in hist]),
            "kernel_only_ms": median_ms([lambda s=s: adam.launch(s, cot, p, m, v, hyper, dense)
                                         for s in sorted_sets]),
            "sort_ms": median_ms([lambda x=x: grad.sort_ids(x, num_rows) for x in hist]),
            "plain_ms": median_ms([lambda x=x: adam.planned_adam_update_reference(
                x, cot, p, m, v, hyper, dense) for x in hist]),
            "bytes": moved, "bound_ms": moved / bandwidth * 1e3,
            "skewed_ms": {kind: median_ms([lambda x=x: adam.planned_adam_update(
                x, cot, p, m, v, hyper, dense)], SKEW_LAUNCHES) for kind, x in skewed.items()},
        }
        out[key]["bound_share"] = out[key]["bound_ms"] / out[key]["ms"]
        del p, m, v, state, sorted_sets
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
    for dim in ADAM_EDGE_DIMS:
        e_state = adam_state(EDGE_ROWS, dim, gen)
        rows = torch.randn(5000, dim, generator=gen, device="cuda") * 1e-3
        for kind in EDGE_KINDS:
            e_ids = edge_ids(kind, 5000, EDGE_ROWS, gen)
            check_adam_step(e_ids, rows[:e_ids.numel()], e_state, adam.adam_hyper(2, LR),
                            f"edge D={dim} {kind}")
            edges.append(f"D={dim},{kind}")
    # a table, moments and dense gradient 4 bytes past a 16-byte boundary:
    # the kernel's float-at-a-time path, the same bits as the float4 one
    e_ids = edge_ids("random_out_of_range", 5000, EDGE_ROWS, gen)
    rows = torch.randn(5000, 8, generator=gen, device="cuda") * 1e-3
    dense = torch.randn(EDGE_ROWS, 8, generator=gen, device="cuda") * 1e-3
    e_state = adam_state(EDGE_ROWS, 8, gen)
    shifted = [torch.empty(EDGE_ROWS * 8 + 1, device="cuda")[1:].view(EDGE_ROWS, 8)
               for _ in range(4)]
    for dst, t in zip(shifted, (*e_state, dense)):
        dst.copy_(t)
    check_adam_step(e_ids, rows, e_state, adam.adam_hyper(2, LR), "edge D=8 dense", dense)
    aligned = [t.clone() for t in e_state]
    adam.planned_adam_update(e_ids, rows, *aligned, adam.adam_hyper(2, LR), dense)
    adam.planned_adam_update(e_ids, rows, *shifted[:3], adam.adam_hyper(2, LR), shifted[3])
    for a, b in zip(aligned, shifted):
        require_equal(b, a, "edge D=8 unaligned against aligned")
    edges.append("D=8,unaligned")
    for dim in (2049, 4096):  # a row a tile: single floats, then float4s
        w_ids = torch.randint(-2, 39, (300,), generator=gen, device="cuda", dtype=torch.int32)
        check_adam_step(w_ids, torch.randn(300, dim, generator=gen, device="cuda") * 1e-3,
                        adam_state(37, dim, gen), adam.adam_hyper(2, LR), f"wide D={dim}")
        edges.append(f"D={dim},wide")

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
    sorted_sets = [adam.sort_for(x, num_rows) for x in id_sets]
    long_sets = [x.long() for x in id_sets]
    lib_p = torch.nn.Parameter(p.clone())
    lib_p.grad = torch.zeros_like(p)
    lib_opt = torch.optim.Adam([lib_p], lr=LR, betas=(0.9, 0.999), eps=1e-8, fused=True,
                               capturable=True)

    def library(x):
        lib_p.grad.zero_().index_add_(0, x, cot)
        lib_opt.step()

    seq = phase_fused_adam_seq(bandwidth)
    row = {
        "name": "fused_adam", "route": "cuda",
        "source": "rec_pangu_tpu_torch/csrc/fused_adam.cu",
        "replaces": "rec_pangu_tpu/ops/kernels/fused_adam.py:54",
        "max_abs_err": max(max_abs_err, seq["max_abs_err"]),
        "tolerance": "rows hit <= once bit-equal; more: m, v within the gradient's sum "
                     "bound, p within 2*lr",
        "ms": median_ms([lambda x=x: adam.planned_adam_update(x, cot, p, m, v, hyper)
                         for x in id_sets]),
        "kernel_only_ms": median_ms([lambda s=s: adam.launch(s, cot, p, m, v, hyper)
                                     for s in sorted_sets]),
        "sort_ms": median_ms([lambda x=x: grad.sort_ids(x, num_rows) for x in id_sets]),
        "plain_ms": median_ms([lambda x=x: adam.planned_adam_update_reference(
            x, cot, p, m, v, hyper) for x in id_sets]),
        "bound_ms": moved / bandwidth * 1e3, "bound_by": "bytes",
        "library_ms": median_ms([lambda x=x: library(x) for x in long_sets]),
        "library": "index_add_ into a zeroed gradient, then torch.optim.Adam(fused=True).step",
        "call_ms": call_ms(lambda: adam.planned_adam_update(ids, cot, p, m, v, hyper)),
        "bytes": moved, "edge_cases": edges, "skewed": skewed,
        "sequence_shape": seq, "tile_plan": adam.tile_plan(num_rows, DIM, sms())._asdict(),
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


@functools.lru_cache(maxsize=2)
def bench_enc_dict(vocab: int = VOCAB) -> dict:
    """The bench's enc_dict: 16 fields of ``vocab`` ids, 9 dense columns
    (one dict, built once: callers do not change it)."""
    enc_dict = {}
    for f in range(FIELDS):
        mapping = {str(i): i for i in range(vocab)}
        mapping["vocab_size"] = vocab
        enc_dict[f"C{f + 1}"] = mapping
    for d in range(DENSE):
        enc_dict[f"I{d + 1}"] = {"min": 0.0, "max": 1.0}
    return enc_dict


def write_checkpoint(path: str) -> dict:
    """A DeepFM checkpoint in the JAX package's layout, made with numpy from
    the seed: flax-named params plus an enc_dict of 16 x 100,000 vocab and 9
    dense columns."""
    rng = np.random.default_rng(SEED)
    enc_dict = bench_enc_dict()
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


def rank_config(name: str) -> dict:
    """The ranking model ``name`` at the bench's width with its JAX class's
    other defaults (DeepFM's MLP (64, 64, 64) is its default too); a
    multi-task model takes every default, its width too (bench.py sets no
    embedding_dim for MMOE: D = 40; AITM's is 32)."""
    if name == "LR" or name in MTL_NAMES:
        return {}
    return {"embedding_dim": DIM, **({"hidden_units": HIDDEN} if name == "DeepFM" else {})}


def write_rank_checkpoint(path: str, name: str, seed: int) -> dict:
    """A checkpoint of the ranking model ``name`` in the JAX package's layout
    at the bench's width: the port's init from ``seed`` (the JAX package's
    distributions), small random biases and LayerNorm terms, and BatchNorm's
    running statistics (AFN's) those of one request's batch, as training
    leaves them: at their init (mean 0, variance 1), AFN's exp_bn would
    scale its inputs, of variance near 1e4, by about 1e2, and the
    predictions would carry that many roundings."""
    enc_dict = bench_enc_dict()
    model = port.get_model(name)(enc_dict=enc_dict, **rank_config(name), seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
        norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)]
        if norms:
            momenta = [m.momentum for m in norms]
            for m in norms:
                m.momentum = 1.0  # the running statistics become the batch's
            req = make_requests(1, seed + 2)[0]
            model(model.upload_batch(req, torch.device("cpu")), train=True, seed=0)
            for m, momentum in zip(norms, momenta):
                m.momentum = momentum
    variables = jax_variables(model)  # weights only: load_model reads no enc_dict
    save_checkpoint(path, variables["params"], variables["batch_stats"])
    return enc_dict


def num_tables(model) -> int:
    """The model's fused tables: K1 runs once a table a request, K3 (K2 on
    the standard step) once a table a step."""
    return len(fused_tables(model))


def num_heights(model) -> int:
    """The fused tables' distinct heights: the fused step sorts its ids
    once for each."""
    return len({m.table.shape[0] for _, m in fused_tables(model)})


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


def load_model(path: str, enc_dict: dict, device: str, name: str = "DeepFM"):
    """The ranking model ``name`` of the bench's width loaded from ``path``
    onto ``device``."""
    model = port.get_model(name)(enc_dict=enc_dict, **rank_config(name))
    RankTrainer(device=device).load_model(model, path)
    return model


def phase_serving(path: str, enc_dict: dict, device: str = "cuda", name: str = "DeepFM",
                  requests: int = REQUESTS, seed: int = SEED + 1, phase: str = "serving",
                  cpu_checks: int = 3):
    """``requests`` timed requests of the ranking model ``name`` (after
    WARMUP) through load_model and make_ranking_scorer, K1 once a table a
    request; ``cpu_checks`` of them held against the same model on the CPU;
    evaluate_model on a labelled set."""
    t0 = time.perf_counter()
    model = load_model(path, enc_dict, device, name)
    trainer = RankTrainer(device=device)
    score = make_ranking_scorer(model, device=device)
    cpu_score = make_ranking_scorer(load_model(path, enc_dict, "cpu", name), device="cpu")
    setup_s = time.perf_counter() - t0
    tables = num_tables(model)

    n_timed = requests
    requests = make_requests(WARMUP + n_timed, seed)
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
    require_launches(launches, {"embedding_lookup": len(requests) * tables}, phase)

    max_err = 0.0
    for req, pred in zip(requests[:cpu_checks], preds[:cpu_checks]):
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
        "phase": phase, "model": name, "batch": BATCH, "fields": FIELDS,
        "vocab": VOCAB, "dense": DENSE, "config": rank_config(name),
        "table_rows": padded_rows(model.spec.total_rows), "tables": tables,
        "requests": n_timed, "warmup": WARMUP, "launches": launches,
        "cpu_checked_requests": cpu_checks, "max_abs_err_vs_cpu": max_err,
        "atol": SERVING_ATOL,
        "p50_ms": p50 * 1e3, "p90_ms": float(np.percentile(latencies, 90)) * 1e3,
        "examples_per_s": n_timed * BATCH / sum(latencies),
        "eval": metrics, "setup_s": setup_s,
    }
    return summary, model, score, requests[WARMUP:WARMUP + PROFILED]


def phase_profile(model, requests, phase: str = "profile", score=None) -> dict:
    """Where a request's time goes.  Host stages, each ended by a
    synchronize: the id check, the check plus upload, the model's forward,
    the copy back (of every prediction: a multi-task model's ``task{i}_pred``
    too).  Then torch.profiler over ``score`` (the ranking scorer by
    default): device time by operation and the card's idle share of the
    wall time (both under the profiler's own overhead)."""
    from torch.profiler import ProfilerActivity, profile

    dev = next(model.parameters()).device
    rows = padded_rows(model.spec.total_rows)
    stages = {"check_ids": [], "check_and_upload": [], "forward": [], "download": []}
    for req in requests:
        t0 = time.perf_counter()
        check_ids(model.spec, req["sparse"], rows)
        t1 = time.perf_counter()
        inputs = model.upload_batch(req, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            preds = [v for k, v in model(inputs, train=False).items() if k.endswith("pred")]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        torch.stack([p.reshape(-1) for p in preds], dim=1).cpu().numpy()
        t4 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[key].append(dt)

    score = score or make_ranking_scorer(model, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for req in requests:
            score(req)
        wall_s = time.perf_counter() - t0
    busy_s, ops = profile_ops(prof, len(requests), "request")
    n = len(requests)
    return {
        "phase": phase, "requests": n,
        "host_stage_p50_ms": {k: statistics.median(v) * 1e3 for k, v in stages.items()},
        "wall_ms_per_request": wall_s * 1e3 / n,
        "device_busy_ms_per_request": busy_s * 1e3 / n,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "device_ops": ops,
    }


def labelled_loader(score, batches: int, seed: int) -> DataLoader:
    """``batches`` seeded batches whose labels are drawn from ``score`` ([B]
    probabilities, or [B, T] for a multi-task model: task t + 1's label is
    drawn from its probability where task t's is 1, and is 0 elsewhere,
    the click-then-conversion funnel the multi-task models assume)."""
    reqs = make_requests(batches, seed)
    rng = np.random.default_rng(seed + 100)
    arrays = {k: np.concatenate([r[k] for r in reqs]) for k in ("sparse", "dense")}
    probs = np.concatenate([score(r) for r in reqs])
    labels = (rng.random(probs.shape) < probs).astype(np.float32)
    if labels.ndim == 2:
        labels = np.cumprod(labels, axis=1)
    arrays["label"] = labels
    return DataLoader(_Arrays(arrays), batch_size=BATCH)


# each kernel's launch count: (module, attribute)
COUNTERS = {"embedding_lookup": (lookup, "LAUNCHES"), "embedding_grad": (grad, "LAUNCHES"),
            "radix_sort": (grad, "SORT_LAUNCHES"),
            "fused_adam": (adam, "LAUNCHES"), "fused_encoder": (encoder, "LAUNCHES"),
            "fused_encoder_bwd": (encoder, "BACKWARD_LAUNCHES"),
            "global_attn": (gattn, "LAUNCHES"), "global_attn_bwd": (gattn, "BACKWARD_LAUNCHES"),
            "multimax_ce": (mmce, "LAUNCHES"), "multimax_ce_bwd": (mmce, "BACKWARD_LAUNCHES"),
            # calls on the card that took the plain version by their shape (past a
            # kernel's limits): 0 on every path unless named
            "fused_encoder_plain": (encoder, "PLAIN_ROUTE"),
            "global_attn_plain": (gattn, "PLAIN_ROUTE"),
            "multimax_ce_plain": (mmce, "PLAIN_ROUTE")}


def reset_launches() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_launches() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def require_launches(got: dict, want: dict, what: str) -> None:
    """Every count as ``want`` gives it, 0 where it gives none; the radix
    sort, unless named, once for each table gradient and fused Adam launch
    (both sort their ids first; a fused step of several tables names its
    sorts: one for each table height)."""
    want = {"radix_sort": want.get("embedding_grad", 0) + want.get("fused_adam", 0), **want}
    if any(got[k] != want.get(k, 0) for k in got):
        raise RuntimeError(f"{what}: kernel launches {got}, expected {want} (0 elsewhere)")


def timed_fit(trainer: RankTrainer, model, train_loader, valid_loader, epochs: int,
              device: str, monitor_metric: str = "roc_auc_score"):
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
                         monitor_metric=monitor_metric, log_rounds=10 ** 9)
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


def phase_training(path: str, enc_dict: dict, score, ckpt_dir: str, device: str = "cuda",
                   name: str = "DeepFM", epochs: int = EPOCHS,
                   train_batches: int = TRAIN_BATCHES, valid_batches: int = VALID_BATCHES,
                   std_steps: int = STD_STEPS, seed: int = SEED + 4, phase: str = "training",
                   num_task: int = 1):
    """RankTrainer(num_task).fit on the ranking or multi-task model ``name``
    from the serving checkpoint on the fused step (K1 once a table a step
    and eval batch, K3 once a table a step), with validation, checkpoints
    and early stopping (on task 1's AUC for a multi-task model, whose
    per-task validation metrics the summary then holds) when
    ``valid_batches``; then ``std_steps`` standard steps (K2 for K3).  The
    loss falls: the last epoch's mean below the first's (each batch is seen
    again), and with a validation set the last three steps' below the first
    three's.  Returns (summary, trained trainer, train batches)."""
    t0 = time.perf_counter()
    train_loader = labelled_loader(score, train_batches, seed)
    valid_loader = labelled_loader(score, valid_batches, seed + 1) if valid_batches else None
    model = load_model(path, enc_dict, device, name)
    trainer = RankTrainer(num_task=num_task, device=device, model_ckpt_dir=ckpt_dir)
    monitor = "roc_auc_score" if num_task == 1 else "test_task1_roc_auc_score"
    setup_s = time.perf_counter() - t0
    tables = num_tables(model)

    # the main path: every count is 0 just before it and read just after
    reset_launches()
    t0 = time.perf_counter()
    metric, times, losses = timed_fit(trainer, model, train_loader, valid_loader, epochs,
                                      device, monitor)
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    steps = epochs * train_batches
    require_launches(launches, {"embedding_lookup": (steps + epochs * valid_batches) * tables,
                                "fused_adam": steps * tables,
                                "radix_sort": steps * num_heights(model)}, f"{name} fused fit")
    if not trainer._train_step.fused:
        raise RuntimeError(f"{name}'s fit did not take the fused step")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    epoch_means = [float(np.mean(losses[i:i + train_batches]))
                   for i in range(0, steps, train_batches)]
    if not (np.all(np.isfinite(losses)) and epoch_means[-1] < epoch_means[0]
            and (valid_loader is None or last < first)):
        raise RuntimeError(f"the {name} training loss did not fall: {losses}")
    files = sorted(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else []
    if valid_loader is not None:
        want = {f"model_e_{i}.ckpt" for i in range(1, epochs + 1)} | {"model_best.ckpt"}
        if not want <= set(files):
            raise RuntimeError(f"checkpoints missing: {sorted(want - set(files))} of {files}")

    summary = {
        "phase": phase, "model": name, "config": rank_config(name), "batch": BATCH,
        "epochs": epochs, "steps_per_epoch": train_batches, "valid_batches": valid_batches,
        "lr": LR, "table_rows": padded_rows(model.spec.total_rows), "tables": tables,
        "launches": launches, "fused": step_stats(times, BATCH), "fit_s": fit_s,
        "setup_s": setup_s, "loss_first3": first, "loss_last3": last,
        "loss_epoch_means": epoch_means, "losses": losses,
        "train_metric": metric, "checkpoints": files,
    }
    if num_task > 1 and valid_loader is not None:  # each task's validation AUC
        summary["valid_metric"] = trainer.evaluate_model(model, valid_loader)
    if std_steps:  # the standard step (REC_PANGU_TPU_FUSED_ADAM=0): K1 + K2 + torch Adam
        std_loader = DataLoader(_Arrays({k: v[:std_steps * BATCH] for k, v in
                                         train_loader.dataset.arrays.items()}),
                                batch_size=BATCH)
        std_model = load_model(path, enc_dict, device, name)
        std_trainer = RankTrainer(num_task=num_task, device=device, model_ckpt_dir=ckpt_dir)
        os.environ["REC_PANGU_TPU_FUSED_ADAM"] = "0"
        try:
            reset_launches()
            _, std_times, std_losses = timed_fit(std_trainer, std_model, std_loader, None, 1,
                                                 device)
            std_launches = read_launches()
        finally:
            del os.environ["REC_PANGU_TPU_FUSED_ADAM"]
        require_launches(std_launches, {"embedding_lookup": std_steps * tables,
                                        "embedding_grad": std_steps * tables},
                         f"{name} standard-step fit")
        if std_trainer._train_step.fused or not np.all(np.isfinite(std_losses)):
            raise RuntimeError(f"the {name} standard step did not run cleanly: {std_losses}")
        summary.update({"standard_launches": std_launches,
                        "standard": step_stats(std_times, BATCH),
                        "standard_losses": std_losses})
    return summary, trainer, train_loader


def phase_card_vs_cpu(path: str, enc_dict: dict, batches, devices=("cuda", "cpu"),
                      name: str = "DeepFM", phase: str = "card_vs_cpu") -> dict:
    """The first fused steps from the same weights on the card (kernels) and
    on the CPU (plain versions), at the bench's width: losses, the dense
    parameters and each table after one step."""
    runs = {}
    for dev in devices:
        model = load_model(path, enc_dict, dev, name).train()
        step = maybe_enable_fused_update(model, LR, TRAIN_BATCHES,
                                         generator=torch.Generator().manual_seed(SEED))
        table_keys = [f"{t}.table" for t, _ in step.tables]
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
    dense_err = max(d.max().item() for k, d in diffs.items() if k not in table_keys)
    beyond = {k: int((diffs[k] > TABLE_ATOL).sum().item()) for k in table_keys}
    table_err = {k: diffs[k].max().item() for k in table_keys}
    summary = {"phase": phase, "model": name, "steps": len(batches),
               "card_losses": card_losses, "cpu_losses": cpu_losses,
               "loss_max_rel_diff": loss_rel, "dense_max_abs_diff": dense_err,
               "table_max_abs_diff": table_err, "table_elements_beyond_atol": beyond,
               "table_elements": {k: diffs[k].numel() for k in table_keys},
               "loss_rtol": LOSS_RTOL, "dense_atol": DENSE_ATOL, "table_atol": TABLE_ATOL,
               "handful": HANDFUL}
    if (loss_rel > LOSS_RTOL or dense_err > DENSE_ATOL or max(beyond.values()) > HANDFUL
            or max(table_err.values()) > 2 * LR):
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


def phase_train_profile(trainer: RankTrainer, batches, phase: str = "train_profile") -> dict:
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
    return {"phase": phase, "steps": n, "wall_ms_per_step": wall_s * 1e3 / n,
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
    """torch.nn.TransformerEncoder (post-LN, batch_first, ``enc``'s
    activation with gelu in its tanh form, dropout 0, the same eps) holding
    ``enc``'s weights."""
    first = enc.blocks[0]
    dim, inner = first.query.weight.shape[0], first.ffn_1.weight.shape[0]
    activation = {"relu": "relu",
                  "gelu": lambda h: torch.nn.functional.gelu(h, approximate="tanh")}.get(
                      enc.hidden_act, torch.nn.functional.silu)
    layer = torch.nn.TransformerEncoderLayer(
        dim, enc.n_heads, dim_feedforward=inner, dropout=0.0, activation=activation,
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
    empty histories, bench.py's 0.9-density masks), at edge shapes, at
    IOCRec's, ContraRec's and CLRec's encoders, at the largest shape the
    kernel takes and at widths no multiple of 4; the kernel's launch plan
    against launch_plan; times of the kernel, the plain version and
    torch.nn.TransformerEncoder, and at IOCRec's training shape
    (encoder_iocrec_times)."""
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
    # IOCRec's local encoder at its training batch (every key valid);
    # ContraRec's and CLRec's BERT4Rec encoder (bidirectional, 2 heads, relu,
    # inner D, eps 1e-5); the largest shape the kernel takes; widths no
    # multiple of 4 (the unaligned paths) and odd sample counts
    ioc = random_encoder(SEQ_DIM, 2, 128, 3, "relu", SEED + 47, dev, IOC_CONFIG["layer_norm_eps"])
    x_ioc, kv_ioc = x_of(IOC_VIEWS, SEQ_L, SEQ_DIM), torch.ones(IOC_VIEWS, SEQ_L, device=dev)
    cases.append(check_encoder(x_ioc, kv_ioc, ioc, True, f"IOCRec: {IOC_VIEWS} x {SEQ_L} x "
                               f"{SEQ_DIM}, 3 layers of 2 heads, inner 128, relu, eps 1e-12"))
    bert = random_encoder(SEQ_DIM, 2, SEQ_DIM, 2, "relu", SEED + 49, dev, 1e-5)
    cases.append(check_encoder(x, masks["prefix"], bert, False, "ContraRec/CLRec: 2 layers of 2 "
                               "heads, inner 64, relu, eps 1e-5, causal=False"))
    widest = random_encoder(encoder.MAX_D, heads, 4 * encoder.MAX_D, layers, "gelu", SEED + 50, dev)
    cases.append(check_encoder(x_of(65, encoder.MAX_L, encoder.MAX_D),
                               prefix_masks(65, encoder.MAX_L, gen), widest, True,
                               f"limits: N=65 L={encoder.MAX_L} D={encoder.MAX_D} "
                               f"inner={4 * encoder.MAX_D}"))
    for n, length, dim, n_heads, inner_w, causal in ((33, 13, 36, 3, 18, False),
                                                     (5, 7, 6, 2, 10, True),
                                                     (7, 57, 20, 5, 80, False)):
        e = random_encoder(dim, n_heads, inner_w, layers, "gelu", SEED + 48, dev)
        cases.append(check_encoder(x_of(n, length, dim), prefix_masks(n, length, gen), e, causal,
                                   f"N={n} L={length} D={dim} heads={n_heads} inner={inner_w} "
                                   f"causal={causal}"))
    plans = [(length, dim, inner_w, n_heads) for length in (1, 7, 50, 63, 64)
             for dim in (6, 64, 128) for inner_w in (1, dim, 4 * dim) for n_heads in (1, 2)]
    for shape in plans:
        if encoder.kernel_launch_plan(*shape) != encoder.launch_plan(*shape):
            raise RuntimeError(f"K4f's launch plan differs from launch_plan at {shape}: "
                               f"{encoder.kernel_launch_plan(*shape)}")

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
    ioc_row = encoder_iocrec_times(x_ioc, kv_ioc, ioc, bandwidth, fp32)
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
        "launch_plan": encoder.launch_plan(SEQ_L, SEQ_DIM, inner, heads)._asdict(),
        "launch_plans_checked": len(plans), **ioc_row,
        "cases": cases, "seconds": time.perf_counter() - t_start,
    }


def encoder_iocrec_times(x, kv, enc: TransformerEncoder, bandwidth: float, fp32: float) -> dict:
    """K4f at IOCRec's training shape (its relu encoder, dropout 0.5, with
    the saved activations and without), its bound there (the products over
    the float32 rate; x, y, the weights and the stores over the memory
    rate) and torch.nn.TransformerEncoder's forward there (dropout 0)."""
    N, L, D = x.shape
    packed = [t.detach() for t in enc.packed()]
    layers, inner = packed[0].shape[0], packed[2].shape[-1]
    opts = (enc.n_heads, True, enc.hidden_act, enc.layer_norm_eps, IOC_DROP, IOC_DROP, 7)
    with torch.no_grad():
        lib = library_encoder(enc)
        lib_mask = encoder.additive_mask(kv, True)[:, 0].repeat_interleave(enc.n_heads, dim=0)
        out = {
            "iocrec_training_ms": median_ms(
                [lambda: encoder.launch_train(x, kv, packed, *opts, save=True)], 5, 5),
            "iocrec_training_no_save_ms": median_ms(
                [lambda: encoder.launch_train(x, kv, packed, *opts, save=False)], 5, 5),
            "iocrec_library_ms": median_ms([lambda: lib(x, mask=lib_mask)], 5, 5)}
    flop, moved = encoder_work(N, L, D, inner, layers, packed)
    stores = layers * encoder.saved_floats(N * L, D, inner) * 4
    by_ops, by_bytes = flop / fp32 * 1e3, (moved + stores) / bandwidth * 1e3
    out.update(iocrec_flop=flop, iocrec_store_bytes=stores, iocrec_bound_ms=max(by_ops, by_bytes),
               iocrec_bound_by="operations" if by_ops >= by_bytes else "bytes",
               iocrec_bytes_bound_ms=by_bytes,
               iocrec_shape={"N": N, "L": L, "D": D, "heads": enc.n_heads, "inner": inner,
                             "layers": layers, "act": enc.hidden_act, "dropout": IOC_DROP})
    return out


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


def rows_rel_err(got: torch.Tensor, want: torch.Tensor, rows: torch.Tensor) -> float:
    """rel_err over the rows selected by the [R] bool ``rows``."""
    if not bool(rows.any()):
        return 0.0
    return rel_err(got[rows], want[rows])


def encoder_bwd_work(n: int, length: int, dim: int, inner: int, layers: int, packed) -> tuple:
    """(flop, bytes) K4b needs from the saved activations: the weight and
    the input gradients of every projection (twice the forward's products),
    and the attention's backward (dv, dp, dq and dk: twice the forward's
    L x L products) with the scores recomputed (half of them again); the
    saved activations, dy and the mask read, dx and the gradients written,
    the weights read once."""
    proj = 2 * n * length * layers * (4 * dim * dim + 2 * dim * inner)
    attn = 2 * n * length * layers * 2 * length * dim
    flop = 2 * proj + 2 * attn + attn // 2
    moved = (layers * encoder.saved_floats(n * length, dim, inner) + 2 * n * length * dim
             + n * length) * 4 + 2 * sum(t.numel() * 4 for t in packed)
    return flop, moved


def encoder_bwd_parts(saved, kv, dy, packed, opts, launches: int = BWD_LAUNCHES) -> dict:
    """Each launch of K4b alone (layer 0's R, A and W, the weight transposes
    and the final ordered sum; ebwd.Stages): ms by launch."""
    heads, causal, act, _, rate, attn_rate, seed = opts
    stages = ebwd.Stages(saved, kv, dy, packed, heads, causal, act, rate, attn_rate, seed, 0)
    stages.run(*stages.NAMES)  # once in order, so each launch reads written inputs
    return {name: median_ms([fn], launches, 5) for name, fn in stages.calls.items()}


def saved_errors(x, kv, packed, opts) -> tuple:
    """({array: its error}, saved): K4f's training forward (y and each
    layer's saved activations) against ebwd.train_forward_reference on the
    rows with a valid key, each within rows_rel_err of its largest entry."""
    N, L, D = x.shape
    layers, inner, R = packed[0].shape[0], packed[2].shape[-1], N * L
    has = rows_with_key(kv, opts[1]).reshape(R)
    y, saved = encoder.launch_train(x, kv, packed, *opts, save=True)
    ref_y, ref_saved = ebwd.train_forward_reference(x, kv, packed, *opts)
    views, ref_views = (ebwd.saved_views(t, R, D, inner) for t in (saved, ref_saved))
    errs = {"y": rows_rel_err(y.reshape(R, D), ref_y.reshape(R, D), has)}
    for li in range(layers):
        for name in ebwd.SAVED_NAMES:
            errs[f"{name}_{li}"] = rows_rel_err(views[li][name], ref_views[li][name], has)
    return errs, saved


def check_encoder_saved(x, kv, packed, opts, what: str) -> dict:
    """K4f's training forward, y and every saved activation, against the
    plain version within BWD_REL_TOL of each array's largest entry (rows
    with a valid key)."""
    errs, _ = saved_errors(x, kv, packed, opts)
    out = {"case": what, "forward": errs, "max_rel_err": max(errs.values())}
    if not math.isfinite(out["max_rel_err"]) or out["max_rel_err"] > BWD_REL_TOL:
        raise RuntimeError(f"{what}: K4f's training forward differs from the plain version: "
                           f"{out}")
    return out


def check_encoder_bwd_stages(x, kv, packed, opts, what: str) -> dict:
    """K4f's saved activations and each launch of K4b against its plain
    version (ops/kernels/encoder_bwd.py) on the same inputs: the training
    forward's stores against the plain forward's values; the weight
    transposes (equal); then from the last layer to the first, R on dy, A on
    R's dctx and dpre1, W on their outputs, each array within BWD_REL_TOL of
    its largest entry.  dy is zero on the query rows with no valid key (see
    check_encoder_bwd); the forward's arrays are held on the rows with one.
    The kernel's chunk plan must equal the plain version's.  Each launch
    reads the card's outputs of the launch before it."""
    heads, causal, act, eps, rate, attn_rate, seed = opts
    N, L, D = x.shape
    layers, inner = packed[0].shape[0], packed[2].shape[-1]
    R = N * L
    has = rows_with_key(kv, causal).reshape(R)
    forward, saved = saved_errors(x, kv, packed, opts)
    views = ebwd.saved_views(saved, R, D, inner)
    out = {"case": what, "forward": forward}
    for rows in (1, 255, 256, 257, R, 3 * R + 1):
        if ebwd.kernel_rows_per_chunk(rows) != ebwd.wgrad_rows_per_chunk(rows):
            raise RuntimeError(f"{what}: the kernel's chunk plan differs at {rows} rows")
    gen = torch.Generator(device=x.device).manual_seed(seed + 3)
    d = torch.randn(R, D, generator=gen, device=x.device) * has[:, None]
    for li in range(layers - 1, -1, -1):
        sv = views[li]
        st = ebwd.Stages(saved, kv, d.view(N, L, D), packed, heads, causal, act, rate, attn_rate,
                         seed, li)
        st.run("transpose")
        require_equal(st.wt, ebwd.transposed_weights_reference(packed),
                      f"{what}: weight transposes")
        st.run("rows")
        r = {k: v.clone() for k, v in st.buf.items()}
        want = ebwd.rows_backward_reference(d, sv, packed, li, L, act, rate, seed)
        errs = {f"R_{k}": rel_err(r[k], want[k])
                for k in ("dpre1", "dx1", "df", "dh", "dattn", "dctx", "ln_part")}
        st.run("attention")
        want_dx, want_dqkv = ebwd.attention_backward_reference(
            sv, kv, r["dctx"], r["dpre1"], packed, li, heads, causal, attn_rate, seed)
        errs.update(A_dx=rel_err(st.buf["dpre1"], want_dx),
                    A_dqkv=rel_err(st.buf["dqkv"], want_dqkv))
        st.run("wgrad", "sum")
        want_g = ebwd.layer_grads_reference(sv, r["ln_part"], st.buf["dqkv"], r["dattn"],
                                            r["dh"], r["df"], act)
        errs.update({f"W_{k}": rel_err(v, want_g[k]) for k, v in st.layer_grads().items()})
        out[f"layer_{li}"] = errs
        d = st.buf["dpre1"].clone()
    torch.cuda.synchronize()
    worst = max(max(v.values()) for k, v in out.items() if k != "case")
    out["max_rel_err"] = worst
    if not math.isfinite(worst) or worst > BWD_REL_TOL:
        raise RuntimeError(f"{what}: a K4b launch or K4f's saved activations differ from the "
                           f"plain version: {out}")
    return out


def phase_fused_encoder_bwd(bandwidth: float, fp32: float) -> dict:
    """K4b (and K4f's dropout forward) against the plain version's autograd
    at the bench shape (prefix masks with empty histories, bench.py's
    0.9-density masks), dropout 0 and 0.1 from one seed, at edge shapes and
    at IOCRec's (3072 views; gelu, and relu with dropout 0.5); each launch
    against its stage's plain version at both shapes and at two shapes
    whose widths are no multiple of 4; the dropout masks'
    seed dependence and keep share; times of the kernel's backward (whole
    and launch by launch), the training forward with and without its
    stores, the plain backward and torch.nn.TransformerEncoder's, at both
    shapes."""
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
    # the widest shape: its rows launch stages W1 and W2 (512 KB) through
    # shared memory 32 rows at a time
    e = random_encoder(128, heads, 512, layers, "gelu", SEED + 46, dev)
    cases.append(check_encoder_bwd(x_of(64, 64, 128), prefix_masks(64, 64, gen), e, True,
                                   "D=128 inner=512 L=64"))
    # IOCRec's local encoder: 3 layers of 2 heads, inner 128, 3072 views, every
    # key valid; gelu without dropout, and IOCRec's own relu, eps 1e-12 and
    # dropout 0.5
    ioc_shape = (IOC_VIEWS, SEQ_L, SEQ_DIM)
    x_ioc, kv_ioc = x_of(*ioc_shape), torch.ones(IOC_VIEWS, SEQ_L, device=dev)
    e = random_encoder(SEQ_DIM, 2, 128, 3, "gelu", SEED + 47, dev)
    cases.append(check_encoder_bwd(x_ioc, kv_ioc, e, True, "IOCRec shape: 3072 x 50 x 64, "
                                   "3 layers of 2 heads, inner 128", 0.0))
    e = random_encoder(SEQ_DIM, 2, 128, 3, "relu", SEED + 47, dev, IOC_CONFIG["layer_norm_eps"])
    cases.append(check_encoder_bwd_relu(x_ioc, kv_ioc, e, "IOCRec shape, relu, eps 1e-12, "
                                        f"dropout {IOC_DROP}", IOC_DROP))
    # each launch against its stage's plain version, at both shapes
    packed_ioc = [t.detach() for t in e.packed()]
    ioc_opts = (2, True, "relu", 1e-12, IOC_DROP, IOC_DROP, 7)
    stages = [check_encoder_bwd_stages(x, masks["prefix"], [t.detach() for t in enc.packed()],
                                       (heads, True, "gelu", enc.layer_norm_eps, DROP, DROP, 7),
                                       "stages, bench shape, prefix masks"),
              check_encoder_bwd_stages(x_ioc, kv_ioc, packed_ioc, ioc_opts,
                                       "stages, IOCRec shape, relu, dropout 0.5")]
    # widths that are no multiple of 4 (D, dh, inner): the launches' unaligned paths
    for n, length, dim, n_heads, inner_w, causal in ((33, 13, 36, 3, 18, False),
                                                     (5, 7, 6, 2, 10, True)):
        eo = random_encoder(dim, n_heads, inner_w, layers, "gelu", SEED + 48, dev)
        xo, kvo = x_of(n, length, dim), prefix_masks(n, length, gen)
        what = f"D={dim} heads={n_heads} inner={inner_w} L={length} causal={causal}"
        cases.append(check_encoder_bwd(xo, kvo, eo, causal, what))
        stages.append(check_encoder_bwd_stages(
            xo, kvo, [t.detach() for t in eo.packed()],
            (n_heads, causal, "gelu", eo.layer_norm_eps, DROP, DROP, 7), f"stages, {what}"))

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
        "forward_no_save_ms": median_ms([lambda: encoder.launch_train(
            x, kv, packed, *opts, DROP, DROP, 7, save=False)]),
        "fwd_bwd_ms": median_ms(fwd_bwd(kernel, grad_packed), BWD_LAUNCHES),
        "plain_fwd_bwd_ms": median_ms(fwd_bwd(plain, grad_packed), BWD_LAUNCHES),
        "plain_forward_ms": median_ms(forward(plain), BWD_LAUNCHES),
        "library_fwd_bwd_ms": median_ms(fwd_bwd(library, lib_params), BWD_LAUNCHES),
        "library_forward_ms": median_ms(forward(library), BWD_LAUNCHES),
    }
    times["plain_ms"] = times["plain_fwd_bwd_ms"] - times["plain_forward_ms"]
    times["library_ms"] = times["library_fwd_bwd_ms"] - times["library_forward_ms"]
    _, saved = encoder.launch_train(x, kv, packed, *opts, DROP, DROP, 7, save=True)
    times["parts"] = encoder_bwd_parts(saved, kv, dy, packed, (*opts, DROP, DROP, 7))
    times["saved_bytes"] = saved.numel() * 4
    del saved
    # at IOCRec's shape and rates (relu, eps 1e-12, dropout 0.5), and
    # torch.nn.TransformerEncoder there without dropout
    _, saved_ioc = encoder.launch_train(x_ioc, kv_ioc, packed_ioc, *ioc_opts, save=True)
    dy_ioc = torch.randn(ioc_shape, generator=gen, device=dev)
    times["iocrec_shape_ms"] = median_ms(
        [lambda: encoder.launch_backward(saved_ioc, kv_ioc, dy_ioc, packed_ioc, *ioc_opts)], 5, 5)
    times["iocrec_shape_parts"] = encoder_bwd_parts(saved_ioc, kv_ioc, dy_ioc, packed_ioc,
                                                    ioc_opts, 5)
    times["iocrec_shape_saved_bytes"] = saved_ioc.numel() * 4
    del saved_ioc
    times["iocrec_shape_forward_ms"] = median_ms(
        [lambda: encoder.launch_train(x_ioc, kv_ioc, packed_ioc, *ioc_opts, save=True)], 5, 5)
    times["iocrec_shape_forward_no_save_ms"] = median_ms(
        [lambda: encoder.launch_train(x_ioc, kv_ioc, packed_ioc, *ioc_opts, save=False)], 5, 5)
    ioc_lib = library_encoder(e).train()
    ioc_lib_params = list(ioc_lib.parameters())
    ioc_mask = encoder.additive_mask(kv_ioc, True)[:, 0].repeat_interleave(2, dim=0)

    def ioc_fwd_bwd():
        xs = x_ioc.detach().requires_grad_()
        torch.autograd.grad(ioc_lib(xs, mask=ioc_mask), [xs] + ioc_lib_params, dy_ioc)

    def ioc_forward():
        with torch.no_grad():
            ioc_lib(x_ioc, mask=ioc_mask)

    times["iocrec_shape_library_fwd_bwd_ms"] = median_ms([ioc_fwd_bwd], 5, 5)
    times["iocrec_shape_library_forward_ms"] = median_ms([ioc_forward], 5, 5)
    times["iocrec_shape_library_ms"] = (times["iocrec_shape_library_fwd_bwd_ms"]
                                        - times["iocrec_shape_library_forward_ms"])
    del dy_ioc, ioc_lib, ioc_lib_params
    ioc_flop, ioc_moved = encoder_bwd_work(IOC_VIEWS, SEQ_L, SEQ_DIM, 128, 3, packed_ioc)
    times["iocrec_shape_bound_ms"] = max(ioc_flop / fp32, ioc_moved / bandwidth) * 1e3
    flop, moved = encoder_bwd_work(SEQ_BATCH, SEQ_L, SEQ_DIM, inner, layers, packed)
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
                   "plain_ms and library_ms: forward+backward minus forward; at IOCRec's "
                   "shape relu, 2 heads, inner 128, 3 layers, eps 1e-12)",
        "stages": stages,
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
                   kernels=("embedding_lookup", "fused_encoder"), label: str = "") -> dict:
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
    return {"phase": "seq_eval" if name == "SASRec" else f"{label or name.lower()}_eval",
            "model": name,
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
            "device_idle_share": 1.0 - busy_s / wall_s,
            "device_kernels_per_step": device_kernels(prof) / n, "device_ops": ops,
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
    and d_items within MM_REL_TOL of each array's largest entry, both on
    K5f's lse and end to end (K5b on K5f's lse against the plain backward
    on the plain forward's lse)."""
    lse = mmce.multimax_lse(u, items, valid_v, zero_row0)
    require_equal(mmce.multimax_lse(u, items, valid_v, zero_row0), lse, f"{what}, lse twice")
    ref_lse = mmce.multimax_lse_reference(u, items, valid_v, zero_row0)
    du, di = mmce.multimax_grads(u, items, lse, valid_v, zero_row0)
    du2, di2 = mmce.multimax_grads(u, items, lse, valid_v, zero_row0)
    require_equal(du2, du, f"{what}, du twice")
    require_equal(di2, di, f"{what}, d_items twice")
    del du2, di2
    ref_du, ref_di = mmce.multimax_grads_reference(u, items, lse, valid_v, zero_row0)
    e2e_du, e2e_di = mmce.multimax_grads_reference(u, items, ref_lse, valid_v, zero_row0)
    torch.cuda.synchronize()
    B, K, D = u.shape
    out = {"case": what, "chunks": mmce.grads_plan(B, K, D, items.shape[0]).chunks,
           "lse": rel_err(lse, ref_lse), "du": rel_err(du, ref_du),
           "d_items": rel_err(di, ref_di), "du_end_to_end": rel_err(du, e2e_du),
           "d_items_end_to_end": rel_err(di, e2e_di),
           "padding_and_row0_zero": not bool(di[valid_v:].any())
           and not (zero_row0 and bool(di[0].any()))}
    if (max(out["lse"], out["du"], out["d_items"], out["du_end_to_end"],
            out["d_items_end_to_end"]) > MM_REL_TOL
            or not out["padding_and_row0_zero"]
            or not all(bool(torch.isfinite(t).all()) for t in (lse, du, di))):
        raise RuntimeError(f"{what}: the K-max CE kernels differ from plain: {out}")
    return out


def mm_key_flips(u, items, base: int, ks, ks_ref, p_ref) -> int:
    """(b, v) of a chunk whose k* differs from the plain version's, where p
    is not 0; each must be a near-tie: its two interests' scores, in
    float64, within twice float32's rounding bound of a D-term dot product
    (D 2^-24 of the sum of |u_d item_d|) of each other."""
    diff = (ks != ks_ref) & (p_ref > 0)
    flips = int(diff.sum())
    if flips:
        b, v = diff.nonzero(as_tuple=True)
        rows = items[base + v].double()
        ua, ub = u[b, ks[b, v].long()].double(), u[b, ks_ref[b, v].long()].double()
        bound = 2 * u.shape[2] * 2.0 ** -24 * torch.maximum((ua * rows).abs().sum(-1),
                                                             (ub * rows).abs().sum(-1))
        gap = ((ua - ub) * rows).sum(-1).abs()
        if bool((gap > bound).any()):
            raise RuntimeError(f"k* differs from the plain version's by more than a rounding "
                               f"at {int((gap > bound).sum())} of {flips} pairs")
    return flips


def check_multimax_stages(u, items, valid_v: int, zero_row0: bool, what: str) -> dict:
    """Each launch of K5b against its stage's plain version, chunk by chunk
    of the plan: P's p within MM_REL_TOL of its largest entry and k* equal
    but at near-ties (mm_key_flips) against ``pairs_reference``, on the
    columns P writes (the tiles up to the last valid item's); U's partials
    summed by S, within MM_REL_TOL of the chunk's du's largest entry; D's
    d_items rows against ``items_reference`` on the card's own p and k*,
    within MM_REL_TOL, zero past the valid tiles, no row outside the chunk
    written.  The plan's words agree with the library's."""
    B, K, D = u.shape
    rows = items.shape[0]
    plan = mmce.grads_plan(B, K, D, rows)
    _, (_, words, _) = mmce._functions()
    if words(B, K, D, rows, plan.chunk_tiles, plan.tiles_per_split) != plan.words:
        raise RuntimeError(f"{what}: the library's workspace words differ from the plan's")
    lse = mmce.multimax_lse(u, items, valid_v, zero_row0)
    work = torch.empty(plan.words, device=u.device)
    p_ws, ks_ws, _ = mmce.workspace_views(work, B, K, D, plan)
    out = {"case": what, "plan": plan._asdict(), "p": 0.0, "du": 0.0, "d_items": 0.0,
           "k_flips": 0, "pairs": 0}
    # P writes the pairs of the tiles that hold valid items, D reads them
    valid_end = -(-valid_v // mmce.ITEM_TILE) * mmce.ITEM_TILE
    for c in range(plan.chunks):
        base = c * plan.chunk_items
        count = min(plan.chunk_items, rows - base)
        live = max(0, min(count, valid_end - base))
        d_items = torch.full_like(items, math.nan)
        if live:
            du = torch.empty_like(u)
            for stage in range(3):
                mmce.launch_grads_stage(u, items, lse, valid_v, zero_row0, plan, work, c, stage,
                                        du)
            p, ks = p_ws[:, :live], ks_ws[:, :live]
            p_ref, ks_ref, du_ref = mmce.pairs_reference(u, items[base:base + live], base, lse,
                                                         valid_v, zero_row0)
            out["p"] = max(out["p"], rel_err(p, p_ref))
            out["du"] = max(out["du"], rel_err(du, du_ref))
            out["k_flips"] += mm_key_flips(u, items, base, ks, ks_ref, p_ref)
            out["pairs"] += p.numel()
            want = mmce.items_reference(u, p, ks)
            del p_ref, ks_ref
        mmce.launch_grads_stage(u, items, lse, valid_v, zero_row0, plan, work, c, 3, d_items)
        torch.cuda.synchronize()
        got = d_items[base:base + count]
        if live and bool(want.any()):
            out["d_items"] = max(out["d_items"], rel_err(got[:live], want))
        if bool(got[live:].any()) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{what}: D of chunk {c} wrote non-zeros past the valid items' "
                               f"tiles, or non-finite values")
        outside = torch.cat([d_items[:base], d_items[base + count:]])
        if not bool(torch.isnan(outside).all()):
            raise RuntimeError(f"{what}: D of chunk {c} wrote outside its rows")
    if max(out["p"], out["du"], out["d_items"]) > MM_REL_TOL:
        raise RuntimeError(f"{what}: a K5b stage differs from its plain version: {out}")
    return out


def mm_bwd_parts(u, items, lse, valid_v: int, zero_row0: bool) -> dict:
    """Each launch of K5b alone, over every chunk of the plan as K5b runs
    them: P (p and k*), U (partial du), S (du summed), D (d_items); ms a
    call."""
    B, K, D = u.shape
    plan = mmce.grads_plan(B, K, D, items.shape[0])
    work = torch.empty(plan.words, device=u.device)
    du, d_items = torch.empty_like(u), torch.empty_like(items)
    outs = (None, None, du, d_items)

    def stage(s):
        def call():
            for c in range(plan.chunks):
                if s == 3 or c * plan.chunk_items < valid_v:
                    mmce.launch_grads_stage(u, items, lse, valid_v, zero_row0, plan, work, c, s,
                                            outs[s], accumulate=c > 0)
        return call

    stage(0)()  # pairs for U and D to read
    stage(1)()
    return {name: median_ms([stage(s)], MM_LAUNCHES, 3) for s, name in enumerate("PUSD")}


def phase_multimax_ce(bandwidth: float, fp32: float, tf32: float) -> tuple:
    """K5f and K5b against their plain versions at the bench shape (1024
    users x 4 interests x 64 against the raw [1,007,616, 64] table, 1,000,000
    valid items, row 0 read as zero; K5b in 5 workspace chunks) and at edge
    shapes (odd item counts, one valid item, K=1 and 3, D=24 and 128, all
    interests equal; valid_v on a chunk boundary at the bench shape; other
    tables of several chunks, with more users, valid_v on a chunk boundary
    and inside a tile); each launch of K5b against its stage's plain version
    (check_multimax_stages, whose ``k_flips`` count the pairs where K5f's
    and P's z picks another interest than the plain version); times of the
    kernels, K5b's launches (mm_bwd_parts) and the plain versions (no
    PyTorch call computes the K-max CE).  K5f is held to the bound of its
    float32 products on the CUDA cores; the row also gives the bound of the
    same products in split TF32 on the tensor cores (three 2 B K D V
    products at the TF32 rate), a route its gates refuse.  Returns the two
    kernel rows."""
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
    # chunk boundaries: the bench table with valid_v on its last boundary (the
    # last chunk holds padding alone), and other tables of several chunks
    # (user counts no multiple of the user tile; valid_v None: on the last
    # chunk's boundary)
    bench_plan = mmce.grads_plan(SEQ_BATCH, 4, SEQ_DIM, rows)
    edge = (bench_plan.chunks - 1) * bench_plan.chunk_items
    cases.append(check_multimax(u, table, edge, True, f"bench shape, valid_v={edge} on a "
                                                      f"chunk boundary"))
    stages = [check_multimax_stages(u, table, SEQ_VOCAB, True, "bench shape")]
    for b, k, dim, n, valid, z0 in ((4100, 3, 24, 150_000, None, True),
                                    (3000, 4, SEQ_DIM, 80_000, 70_001, False),
                                    (2100, 4, 128, 120_000, 120_000, True)):
        uu = torch.randn(b, k, dim, generator=gen, device=dev) * 0.5
        items = torch.randn(n, dim, generator=gen, device=dev)
        plan = mmce.grads_plan(b, k, dim, n)
        valid = valid or (plan.chunks - 1) * plan.chunk_items
        what = (f"B={b} K={k} D={dim} rows={n} valid={valid} row0={z0}, {plan.chunks} chunks "
                f"of {plan.chunk_tiles} tiles")
        cases.append(check_multimax(uu, items, valid, z0, what))
        stages.append(check_multimax_stages(uu, items, valid, z0, what))
        del uu, items

    lse = mmce.multimax_lse(u, table, SEQ_VOCAB, True)
    t = {"fwd": median_ms([lambda: mmce.launch_lse(u, table, SEQ_VOCAB, True)], MM_LAUNCHES, 5),
         "bwd": median_ms([lambda: mmce.launch_grads(u, table, lse, SEQ_VOCAB, True)],
                          MM_LAUNCHES, 3),
         "plain_fwd": median_ms([lambda: mmce.multimax_lse_reference(u, table, SEQ_VOCAB, True)],
                                MM_LAUNCHES, 3),
         "plain_bwd": median_ms([lambda: mmce.multimax_grads_reference(u, table, lse, SEQ_VOCAB,
                                                                         True)], MM_LAUNCHES, 3)}
    parts = mm_bwd_parts(u, table, lse, SEQ_VOCAB, True)
    flop = mm_work(SEQ_BATCH, 4, SEQ_DIM, SEQ_VOCAB)
    u_bytes, table_bytes, lse_bytes = u.numel() * 4, table.numel() * 4, SEQ_BATCH * 4
    # p (f32) and k* (u8) of each valid tile's pairs, written once by P and
    # read twice, by U and by D
    pairs = SEQ_BATCH * min(-(-SEQ_VOCAB // mmce.ITEM_TILE) * mmce.ITEM_TILE, rows)
    workspace_bytes = 3 * pairs * 5
    out = []
    for name, work, moved, ms, plain_ms, replaces, errs in (
            ("multimax_ce", flop, u_bytes + table_bytes + lse_bytes, t["fwd"], t["plain_fwd"],
             "rec_pangu_tpu/ops/kernels/multimax_ce.py:72", ("lse",)),
            ("multimax_ce_bwd", mm_bwd_work(SEQ_BATCH, 4, SEQ_DIM, SEQ_VOCAB),
             2 * (u_bytes + table_bytes) + lse_bytes + workspace_bytes, t["bwd"],
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
    # K5f: held to its float32 products' bound; split TF32's beside it
    out[0].update({"ops_bound_split_tf32_ms": 3 * flop / tf32 * 1e3,
                   "bound_held_to": "float32: 2 B K D V FLOP at the CUDA cores' float32 rate "
                                    "(ops_bound_ms); ops_bound_split_tf32_ms: 3 x 2 B K D V "
                                    "at the TF32 tensor-core rate"})
    out[1].update({"parts": parts, "workspace_bytes": workspace_bytes,
                   "workspace_words": bench_plan.words, "plan": bench_plan._asdict(),
                   "cases": cases, "stages": stages,
                   "seconds": time.perf_counter() - t_start})
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
                        seed: int, device: str = "cuda", requests: int = 0,
                        label: str = "", cpu_users: int = IOC_CPU_USERS):
    """Retrieval by the sequence model ``name`` at full width from a
    JAX-layout checkpoint: SequenceTrainer.load_model, make_retrieval_scorer,
    1024 histories a request, top-200 of the whole L2-normalized corpus (a
    multi-interest model scores each item by its best interest), each of
    ``kernels`` once a request (IOCRec: K1 + K4f + K6f); two requests held
    against the CPU on their first ``cpu_users`` histories (IOC_CPU_USERS;
    SEQ_BATCH: whole requests).  ``requests`` (SEQ_REQUESTS when 0) timed
    after SEQ_WARMUP; ``label`` names the phase (the model's name)."""
    t_start = time.perf_counter()
    model = load_seq_model(path, enc_dict, device, name, config)
    retrieve = make_retrieval_scorer(model, topk=SEQ_TOPK, device=device)
    setup_s = time.perf_counter() - t_start
    n_timed = requests or SEQ_REQUESTS
    requests = make_seq_requests(SEQ_WARMUP + n_timed, seed)

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
    phase = f"{label or name.lower()}_serving"
    require_launches(launches, {k: n for k in kernels}, phase)

    cpu_model = load_seq_model(path, enc_dict, "cpu", name, config)
    cpu_retrieve = make_retrieval_scorer(cpu_model, topk=SEQ_TOPK + 1, device="cpu")
    emb_err, differing = 0.0, 0
    for req in requests[:IOC_CPU_CHECKS]:
        part = {k: v[:cpu_users] for k, v in req.items()}
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
        "requests": n_timed, "warmup": SEQ_WARMUP, "launches": launches,
        "launches_per_request": {k: v / n for k, v in launches.items() if v},
        "p50_ms": statistics.median(latencies) * 1e3,
        "p90_ms": float(np.percentile(latencies, 90)) * 1e3,
        "users_per_s": n_timed * SEQ_BATCH / sum(latencies),
        "cpu_checked_requests": IOC_CPU_CHECKS, "cpu_checked_users": cpu_users,
        "user_emb_max_abs_err_vs_cpu": emb_err, "user_emb_atol": USER_EMB_ATOL,
        "score_atol": SCORE_ATOL,
        "topk_positions_compared": IOC_CPU_CHECKS * cpu_users * SEQ_TOPK,
        "topk_positions_differing_at_ties": differing,
        "setup_s": setup_s, "seconds": time.perf_counter() - t_start,
    }
    return summary, model, requests[SEQ_WARMUP:SEQ_WARMUP + SEQ_PROFILED]


def phase_model_training(path: str, enc_dict: dict, ckpt_dir: str, name: str, config: dict,
                         per_step, per_batch, seed: int, std_steps: int = 0,
                         epochs: int = FIT_EPOCHS, device: str = "cuda", label: str = "",
                         train_batches: int = FIT_TRAIN_BATCHES):
    """SequenceTrainer.fit on the sequence model ``name`` at full width from
    the JAX-layout checkpoint: ``epochs`` of ``train_batches`` bench-shape
    batches with the host keys the trainer attaches (IOCRec's and
    ContraRec's views, CLRec's lookup_all, the SRGNN family's session
    graph), FIT_VALID_BATCHES of
    validation, log.csv, checkpoints and early stopping, on the sequence
    fused step: each of ``per_step`` once a step, each of ``per_batch`` once
    a step and an eval batch (IOCRec: K1, K4f, K4b, K6f, K6b, K5f, K5b, K3).
    Then ``std_steps`` standard steps (K2 for K3).  ``label`` names the
    phase (the model's name)."""
    t_start = time.perf_counter()
    train_loader = seq_train_loader(train_batches, seed)
    valid_loader = seq_valid_loader(FIT_VALID_BATCHES, seed + 1)
    model = load_seq_model(path, enc_dict, device, name, config)
    trainer = SequenceTrainer(device=device, model_ckpt_dir=ckpt_dir)
    setup_s = time.perf_counter() - t_start

    # the main path: every count is 0 just before it and read just after
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    times, losses = timed_seq_fit(trainer, model, train_loader, valid_loader, epochs, device)
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    steps, evals = epochs * train_batches, epochs * FIT_VALID_BATCHES
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
        "phase": f"{label or name.lower()}_training", "model": name, "config": config,
        "vocab": SEQ_VOCAB, "batch": SEQ_BATCH, "epochs": epochs,
        "steps_per_epoch": train_batches, "valid_batches": FIT_VALID_BATCHES, "lr": LR,
        "launches": launches, "fused": step_stats(times, SEQ_BATCH), "fit_s": fit_s,
        "setup_s": setup_s, "loss_first3": first, "loss_last3": last, "losses": losses,
        "files": files, "peak_allocated_bytes": peak,
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
                          summary: dict, grad_rel_tol: float = IOC_GRAD_REL_TOL,
                          dense_handful: int = IOC_DENSE_HANDFUL) -> None:
    """A card-against-CPU leg within its bounds: the step-1 loss within
    IOC_LOSS_RTOL and the later ones within ``later_rtol``; the first step's
    gradients within ``grad_rel_tol`` of each leaf's largest entry
    (``kink_rel_tol`` on the relu's path, the exact zeros of their weight's);
    the parameters after one step: dense elements past SEQ_DENSE_ATOL at most
    ``dense_handful``, table elements past SEQ_TABLE_ATOL at most
    SEQ_HANDFUL, none of either past 2 lr."""
    lr = leg["lr"]
    losses_ok = (leg["loss_rel_diffs"][0] <= IOC_LOSS_RTOL
                 and max(leg["loss_rel_diffs"]) <= later_rtol)
    grads_ok = (leg["grad_rel_err"] <= grad_rel_tol
                and leg["kink_path_grad_rel_err"] <= kink_rel_tol
                and leg["zero_grad_rel_size"] <= IOC_GRAD_REL_TOL)
    if (not losses_ok or not grads_ok
            or leg["dense_elements_beyond_atol"] > dense_handful
            or leg["dense_max_abs_diff"] > 2 * lr
            or leg["table_elements_beyond_atol"] > SEQ_HANDFUL
            or leg["table_max_abs_diff"] > 2 * lr):
        raise RuntimeError(f"the card's training differs from the CPU's: {summary}")


@contextlib.contextmanager
def recording_table_grad(out: list):
    """Within it, the fused steps append each step's table gradients (the
    captured rows summed at their ids plus the CE's dense stream), on the
    CPU, to ``out`` before each table update: ``SeqFusedStep``'s through
    ``planned_adam_update``, ``FusedStep``'s through ``update_sorted``."""
    from rec_pangu_tpu_torch.train import fused_update

    update, update_sorted = fused_update.planned_adam_update, fused_update.update_sorted

    def record(ids, rows, table, dense):
        grad = torch.zeros_like(table) if dense is None else dense.clone()
        out.append(grad.index_add_(0, ids.long(), rows).cpu())

    def recorded(ids, rows, table, mu, nu, hyper, dense=None):
        record(ids, rows, table, dense)
        return update(ids, rows, table, mu, nu, hyper, dense)

    def recorded_sorted(plan, rows, table, mu, nu, hyper, dense=None):
        record(plan.ids, rows, table, dense)
        return update_sorted(plan, rows, table, mu, nu, hyper, dense)

    fused_update.planned_adam_update = recorded
    fused_update.update_sorted = recorded_sorted
    try:
        yield
    finally:
        fused_update.planned_adam_update = update
        fused_update.update_sorted = update_sorted


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
            "zero_grad_rel_size": max(zero.values(), default=0.0), "grad_leaves": len(errs),
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
    dense = torch.cat([torch.zeros(1)] + [d.reshape(-1) for k, d in diffs.items()
                                          if k != table_key and k not in zero])
    table = diffs[table_key]
    return {"lr": lr, "card_losses": card_losses, "cpu_losses": cpu_losses,
            "loss_rel_diffs": [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)],
            **grad_comparison(card_grads, cpu_grads, on_kink_path),
            "dense_max_abs_diff": dense.max().item(),
            "dense_elements_beyond_atol": int((dense > SEQ_DENSE_ATOL).sum().item()),
            "dense_elements": dense.numel() - 1,
            "zero_grad_max_abs_diff": max((diffs[k].max().item() for k in zero), default=0.0),
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

    sorts = check_sorts({**{f"K7 shape {i}": (x, num_rows) for i, x in enumerate(id_sets)},
                         **{f"K7 shape {kind}": (x, num_rows)
                            for kind, x in seq_skewed_ids(num_rows, dev).items()}})

    n = ids.numel()
    moved = num_rows * SEQ_DIM * 4 + n * SEQ_DIM * 4 + n * 4  # grad written; rows, ids read
    long_sets = [x.long() for x in id_sets]
    lib = torch.zeros(num_rows, SEQ_DIM, device=dev)
    row = {
        "name": "embedding_grad_sorted", "route": "cuda",
        "source": "rec_pangu_tpu_torch/csrc/embedding_grad.cu",
        "replaces": "rec_pangu_tpu/ops/kernels/embedding_grad.py:67",
        "max_abs_err": max_abs_err,
        "tolerance": "per element 2(k-1)*2^-24*sum|x| over its k terms (sum order)",
        "ids": n, "table_rows": num_rows, "max_hits_per_row": int(hits.max().item()),
        "ms": median_ms([lambda x=x: accumulate(x, cot, num_rows) for x in id_sets]),
        "plain_ms": median_ms([lambda x=x: grad.table_grad_reference(x, cot, num_rows)
                               for x in id_sets]),
        "bound_ms": moved / bandwidth * 1e3, "bound_by": "bytes",
        "library_ms": median_ms([lambda x=x: lib.zero_().index_add_(0, x, cot)
                                 for x in long_sets]),
        "library": "torch.zeros(V, D).index_add_(0, ids, rows) (atomics)",
        "bytes": moved, "skewed": skewed, "sort_cases": sorts,
    }
    return with_parts(row, table_grad_parts(id_sets, cot, num_rows))


def phase_device_aug(path: str, enc_dict: dict, device: str = "cuda",
                     config: dict = CONTRA_CONFIG,
                     kernels=("embedding_lookup", "fused_encoder", "fused_encoder_bwd"),
                     label: str = "contrarec") -> dict:
    """K7's path: ContraRec standard steps (``train/steps.StandardStep``) on
    bench batches uploaded without ``aug_all``, so that each forward draws
    the two views on the card from the step's seed and looks up [hist; v1;
    v2] [3072, 50] in one lookup no step captures.  Its backward is the
    table gradient over 153,600 ids sorted on the card, once a step, beside
    each of ``kernels`` (the BERT4Rec encoder's K1, K4f and K4b; K1 alone
    for the GRU4Rec and Caser encoders of ``config``); no K3.  The loss
    must be finite and fall over two passes of the batches (new views each
    time)."""
    from rec_pangu_tpu_torch.train.steps import StandardStep

    t_start = time.perf_counter()
    batches = list(seq_train_loader(AUG_STEPS // 2, SEED + 120)) * 2
    model = load_seq_model(path, enc_dict, device, "ContraRec", config).train()
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
    require_launches(launches, {k: AUG_STEPS for k in tuple(kernels) + ("embedding_grad",)},
                     f"{label}_device_aug")
    losses = [float(x) for x in losses]
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not (np.all(np.isfinite(losses)) and last < first):
        raise RuntimeError(f"the device-view training loss did not fall: {losses}")
    return {"phase": f"{label}_device_aug", "model": "ContraRec", "config": config,
            "vocab": SEQ_VOCAB, "batch": SEQ_BATCH, "lookup_ids_per_step": 3 * SEQ_BATCH * SEQ_L,
            "lr": LR, "launches": launches, "standard": step_stats(times, SEQ_BATCH),
            "loss_first3": first, "loss_last3": last, "losses": losses, "setup_s": setup_s,
            "seconds": time.perf_counter() - t_start}


def phase_model_card_vs_cpu(name: str, config: dict, devices=("cuda", "cpu"),
                            later_rtol: float = IOC_LATER_LOSS_RTOL, label: str = "") -> dict:
    """The first three fused steps of the sequence model ``name`` (ContraRec,
    CLRec, the classic models) on the card and on the CPU at a cut corpus
    (SEQ_CPU_VOCAB items, IOC_CPU_BATCH histories), from the same weights,
    batches and dropout seeds, the host keys (ContraRec's views, CLRec's
    lookup_all) made by a trainer's hooks as fit makes them: the first
    step's gradient of every leaf before Adam, the losses (the first within
    IOC_LOSS_RTOL, the later within ``later_rtol``), the parameters after
    one step, held by ``require_card_like_cpu``.  Every leaf's gradient
    within IOC_GRAD_REL_TOL of its largest entry, those behind a relu too:
    no sample of these inputs lies at its kink (ContraRec's and CLRec's
    first run: 1.9e-6 at most; see phase_iocrec_card_vs_cpu).  The summary
    records the TF32 flags the steps ran under."""
    t_start = time.perf_counter()
    trainer = SequenceTrainer(device="cpu")
    trainer.model = port.get_model(name)(enc_dict={"item_id": {"vocab_size": SEQ_CPU_VOCAB}},
                                         config=config)
    batches = [trainer._attach_host_keys(b) for b in
               seq_train_loader(CPU_STEPS, SEED + 130, SEQ_CPU_VOCAB, IOC_CPU_BATCH)]
    leg = card_vs_cpu_leg(name, config, batches, LR, devices, SEED + 131, lambda k: False)
    summary = {"phase": f"{label or name.lower()}_card_vs_cpu", "steps": CPU_STEPS,
               "vocab": SEQ_CPU_VOCAB, "batch": IOC_CPU_BATCH, f"lr_{LR:g}": leg,
               "loss_rtol": IOC_LOSS_RTOL, "later_loss_rtol": later_rtol,
               "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
               "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
               "grad_rel_tol": IOC_GRAD_REL_TOL,
               "dense_atol": SEQ_DENSE_ATOL, "dense_handful": IOC_DENSE_HANDFUL,
               "table_atol": SEQ_TABLE_ATOL, "table_handful": SEQ_HANDFUL}
    require_card_like_cpu(leg, later_rtol, IOC_GRAD_REL_TOL, summary)
    summary["seconds"] = time.perf_counter() - t_start
    return summary


# ------------------------------------------------------ the classic sequence zoo
# at bench.py's sequence width with each JAX class's own defaults
# (rec_pangu_tpu/models/sequence/{gru4rec,yotubednn,narm,stamp,nextitnet}.py):
# GRU4Rec's two-layer GRU of width D; YotubeDNN's mean over the L positions;
# NARM's two-layer GRU of 32 with dropout 0.1 on the embeddings and on the
# encodings; STAMP without feat_drop; NextItNet's two ResBlockTwoMasked at
# dilations (1, 4), kernel 3, no feat_drop.  No transformer: K1 a request,
# step and eval batch, K3 a fused step (K2 a standard step).
CLASSIC_BASE = {"embedding_dim": SEQ_DIM, "max_length": SEQ_L, "item_col": "item_id"}
CLASSIC = (("GRU4Rec", CLASSIC_BASE, SEED + 150), ("YotubeDNN", CLASSIC_BASE, SEED + 160),
           ("NARM", {**CLASSIC_BASE, "n_layers": 2, "hidden_size": 32,
                     "dropout_probs": [0.1, 0.1]}, SEED + 170),
           ("STAMP", {**CLASSIC_BASE, "feat_drop": 0.0}, SEED + 180),
           ("NextItNet", {**CLASSIC_BASE, "dilations": [1, 4], "one_masked": False,
                          "kernel_size": 3, "feat_drop": 0.0}, SEED + 190))
CLASSIC_KERNELS = ("embedding_lookup",)
CLASSIC_EPOCHS = 2         # fit epochs: at one, YotubeDNN's and STAMP's losses do not fall
CLASSIC_REQUESTS = 20      # timed requests of the models after GRU4Rec (GRU4Rec: SEQ_REQUESTS)
CLASSIC_PROFILED = 4       # GRU4Rec's fused steps traced by the profiler
CONTRA_ENCODERS = (("GRU4Rec", SEED + 200), ("Caser", SEED + 210))  # ContraRec's other two
# torch's own TF32 flags (matmul, cuDNN), read before main() turns both off
TORCH_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def torch_default_tf32():
    """Within it, torch's default TF32 flags (cuDNN's on), as a user's fit
    runs: the card-against-CPU gates then show that no convolution or
    product of the classic models leans on main()'s global switch."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = TORCH_TF32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def device_kernels(prof) -> int:
    """Device kernels and copies a torch.profiler trace holds."""
    return sum(e.count for e in prof.key_averages()
               if e.self_device_time_total > 0 and not e.is_user_annotation
               and e.device_type != torch.autograd.DeviceType.CPU)


def phase_gru_share(path: str, enc_dict: dict, batches, config: dict,
                    device: str = "cuda") -> dict:
    """GRU4Rec's GRU alone on the training step's inputs (the bench batches'
    history embeddings, [1024, 50, 64], two layers of 64): forward, and
    forward plus backward, each ended by a synchronize; then torch.profiler
    over forward plus backward: device busy time, idle share and kernels a
    call.  Set beside gru4rec_train_profile's step, it gives the GRU's
    share of the step."""
    from torch.profiler import ProfilerActivity, profile

    t_start = time.perf_counter()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    model = load_seq_model(path, enc_dict, device, "GRU4Rec", config).train()
    inputs = []
    for batch in batches:
        up = model.upload_batch(batch, dev, train=True)
        with torch.no_grad():
            emb = model.item_emb(up["hist_item_list"])
        inputs.append((emb, up["hist_mask_list"].sum(dim=-1).to(torch.int64)))

    def fwd_bwd(emb, lengths):
        model.gru(emb.detach().requires_grad_(), lengths).sum().backward()

    def fwd(emb, lengths):
        with torch.no_grad():
            model.gru(emb, lengths)

    times = {}
    for key, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        fn(*inputs[0])  # warm
        sync()
        times[key] = []
        for args in inputs:
            t0 = time.perf_counter()
            fn(*args)
            sync()
            times[key].append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for args in inputs:
            fwd_bwd(*args)
        sync()
        wall_s = time.perf_counter() - t0
    n = len(inputs)
    busy_s, ops = profile_ops(prof, n, "call")
    return {"phase": "gru4rec_gru", "device": device, "batch": SEQ_BATCH, "length": SEQ_L,
            "layers": 2, "hidden": SEQ_DIM, "calls": n,
            "fwd_p50_ms": statistics.median(times["fwd"]) * 1e3,
            "fwd_bwd_p50_ms": statistics.median(times["fwd_bwd"]) * 1e3,
            "wall_ms_per_call": wall_s * 1e3 / n, "device_busy_ms_per_call": busy_s * 1e3 / n,
            "device_idle_share": 1.0 - busy_s / wall_s,
            "device_kernels_per_call": device_kernels(prof) / n, "device_ops": ops,
            "seconds": time.perf_counter() - t_start}


# ------------------------------------------------------ the ranking zoo
# at bench.py's CTR width (16 fields x 100,000 vocab, 9 dense, D=32,
# 8192-row requests and batches) with each JAX class's own defaults
# (rec_pangu_tpu/models/ranking/*.py): WDL first, with DeepFM's full set of
# phases; the other twelve with serving, a short fit and three fused steps
# card against CPU with their dropout (0.1 in xDeepFM's, AutoInt's,
# MaskNet's, AOANet's and AFN's MLPs) on.  K1 once a table a request, step
# and eval batch; K3 once a table a fused step, K2 once a table a standard
# step (WDL, and the LR models: 2 tables; AFN 2; LR 1).
RANK_ZOO = (("WDL", SEED + 300), ("LR", SEED + 310), ("FM", SEED + 320), ("NFM", SEED + 330),
            ("DCN", SEED + 340), ("xDeepFM", SEED + 350), ("AutoInt", SEED + 360),
            ("FiBiNet", SEED + 370), ("MaskNet", SEED + 380), ("AFM", SEED + 390),
            ("CCPM", SEED + 400), ("AOANet", SEED + 410), ("AFN", SEED + 420))
RANK_REQUESTS = 20         # timed requests of the models after WDL (WDL: REQUESTS)
RANK_CPU_CHECKS = 3        # ... held against the CPU, as DeepFM's
RANK_FIT_EPOCHS, RANK_FIT_BATCHES = 2, 4  # the short fits: each batch seen again
RANK_CPU_VOCAB, RANK_CPU_BATCH = 10_000, 2048  # card against CPU: 16 fields of 10,000 ids
RANK_GRAD_REL_TOL = 1e-5   # ... the first step's gradient of each leaf, of its largest entry
RANK_ZERO_GRAD = {"log_bn.bias": "log_bn.weight"}  # AFN: a gradient of 0 (exp_bn undoes
RANK_ZERO_GRAD_REL = 1e-4  # a shift), rounding noise held as a share of the weight's
RANK_DENSE_HANDFUL = 16    # dense elements allowed past DENSE_ATOL after one step (2 lr at most)
RANK_TABLE_HANDFUL = 512   # table elements allowed past TABLE_ATOL (2 lr at most)
RANK_STATS_RTOL = 1e-4     # BatchNorm running statistics after one step, of their size
# AFN alone: the exp of its logarithmic neurons magnifies a rounding (on the
# CPU its float32 first-step gradients lie up to 1.3e-1 of a leaf's largest
# entry from float64's, its loss 7.5e-4 apart), so its card and CPU
# gradients agree only to a few 1e-3 and more first Adam steps flip sign
# (first card run: 4.79e-3 on afn_mlp.dense.0.weight, 21 dense and 3,016 of
# 10,485,760 table elements past their atol, all within 2 lr)
RANK_LOOSER = {"AFN": {"grad_rel_tol": 1e-2, "dense_handful": 64, "table_handful": 8192}}


def rank_cpu_batches(seed: int, vocab: int = RANK_CPU_VOCAB, batch: int = RANK_CPU_BATCH,
                     num_task: int = 1):
    """CPU_STEPS labelled batches of ``batch`` rows over ``vocab`` ids a
    field (the last id each field's OOV row); a multi-task batch has a
    label a task, [batch, num_task]."""
    rng = np.random.default_rng(seed)
    shape = (batch,) if num_task == 1 else (batch, num_task)
    return [{"sparse": rng.integers(0, vocab + 1, (batch, FIELDS)).astype(np.int32),
             "dense": rng.random((batch, DENSE)).astype(np.float32),
             "label": (rng.random(shape) < 0.3).astype(np.float32)}
            for _ in range(CPU_STEPS)]


def bn_undone_leaves(model) -> dict:
    """The multi-task leaves whose gradient is 0 analytically, each with the
    weight whose largest gradient scales its rounding noise: a bias that a
    BatchNorm right after undoes (each ``TaskTower``'s Linear i before its
    BatchNorm i; its later BatchNorms' biases reach the next one through a
    dropout mask, so they count) and OMOE's expert bias (its gate does not
    depend on the input, so the bias is a shift before the towers' first
    BatchNorm)."""
    out = {}
    for prefix, m in model.named_modules():
        if isinstance(m, TaskTower):
            for i in range(len(m.bn)):
                out[f"{prefix}.dense.{i}.bias"] = f"{prefix}.dense.{i}.weight"
    if isinstance(model, OMOE):
        out["experts.experts_bias"] = "experts.experts"
    return out


def phase_rank_card_vs_cpu(name: str, seed: int, devices=("cuda", "cpu"),
                           vocab: int = RANK_CPU_VOCAB, rows: int = RANK_CPU_BATCH,
                           label: str = "", looser=None) -> dict:
    """The first three fused steps of the ranking or multi-task model
    ``name`` (16 fields of ``vocab`` ids, ``rows`` rows a step, weights
    from ``seed``) on the card and on the CPU, from the same weights,
    batches and dropout seeds (the MLPs' and towers' masks are the same
    hash on both): the first step's gradient of every leaf before Adam (each
    table's as its rows summed at their ids, recorded at its K3 call), the
    losses (each within LOSS_RTOL) and the parameters after one step.  Every
    leaf's gradient within RANK_GRAD_REL_TOL of its largest entry but
    RANK_ZERO_GRAD's and ``bn_undone_leaves``', 0 but for rounding on both
    sides (held within RANK_ZERO_GRAD_REL of their weight's largest
    gradient).  Adam's first step moves an entry by about lr whatever its
    gradient's size, so one with a gradient within rounding of 0 may move
    2 lr apart: at most RANK_DENSE_HANDFUL dense and RANK_TABLE_HANDFUL
    table elements past DENSE_ATOL and TABLE_ATOL, none past 2 lr
    (``bn_undone_leaves``, all noise, within 2 lr only).  AFN's gates are
    RANK_LOOSER's; ``looser`` overrides gates for this leg alone."""
    t_start = time.perf_counter()
    enc_dict = {**{f"C{f + 1}": {"vocab_size": vocab} for f in range(FIELDS)},
                **{f"I{d + 1}": {"min": 0.0, "max": 1.0} for d in range(DENSE)}}
    num_task = MTL_TASKS if name in MTL_NAMES else 1
    batches = rank_cpu_batches(seed + 1, vocab, rows, num_task)
    runs = {}
    for dev in devices:
        model = port.get_model(name)(enc_dict=enc_dict, **rank_config(name), seed=seed)
        model = model.to(dev).train()
        undone = bn_undone_leaves(model)
        step = maybe_enable_fused_update(model, LR, CPU_STEPS,
                                         generator=torch.Generator().manual_seed(SEED))
        table_keys = [f"{t}.table" for t, _ in step.tables]
        losses, table_grads = [], []
        with recording_table_grad(table_grads):
            for i, batch in enumerate(batches):
                out = step(model.upload_batch(batch, torch.device(dev), train=True), i)
                losses.append(float(out["loss"].detach()))
                if i == 0:  # the step leaves each dense leaf's gradient in .grad
                    if len(table_grads) != len(table_keys):
                        raise RuntimeError(f"{name}: {len(table_grads)} table gradients "
                                           f"recorded for {len(table_keys)} tables")
                    grads = {k: p.grad.detach().cpu().clone()
                             for k, p in model.named_parameters() if p.grad is not None}
                    grads.update(zip(table_keys, table_grads))
                    after_one = {k: v.detach().cpu().clone()
                                 for k, v in model.state_dict().items()}
        runs[dev] = (losses, grads, after_one)
    (card_losses, card_grads, card), (cpu_losses, cpu_grads, cpu) = (runs[d] for d in devices)
    if set(card_grads) != set(cpu_grads):
        raise RuntimeError(f"{name}: the card and the CPU give gradients to different leaves")
    zero_grad = {**RANK_ZERO_GRAD, **undone}
    errs = {k: rel_err(card_grads[k], w) for k, w in cpu_grads.items() if k not in zero_grad}
    zero = {k: max(card_grads[k].abs().max().item(), cpu_grads[k].abs().max().item())
            / cpu_grads[w].abs().max().item() for k, w in zero_grad.items()
            if k in cpu_grads}
    # BatchNorm's running statistics (AFN's), held relative to their size:
    # the exp's variance is near 1e4
    stats = [k for k in cpu if ".running_" in k]
    stats_rel = max((((card[k] - cpu[k]).abs() / cpu[k].abs().clamp(min=1.0)).max().item()
                     for k in stats), default=0.0)
    diffs = {k: (card[k] - cpu[k]).abs() for k in cpu
             if k not in stats and not k.endswith("num_batches_tracked")}
    dense = torch.cat([torch.zeros(1)] + [d.reshape(-1) for k, d in diffs.items()
                                          if k not in table_keys and k not in undone])
    undone_diff = max((diffs[k].max().item() for k in undone), default=0.0)
    tables = torch.cat([diffs[k].reshape(-1) for k in table_keys])
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
    worst = max(errs, key=errs.get)
    gates = {"grad_rel_tol": RANK_GRAD_REL_TOL, "dense_handful": RANK_DENSE_HANDFUL,
             "table_handful": RANK_TABLE_HANDFUL, **RANK_LOOSER.get(name, {}), **(looser or {})}
    summary = {"phase": label or f"{name.lower()}_card_vs_cpu", "model": name,
               "steps": CPU_STEPS, "vocab": vocab, "batch": rows, "tables": len(table_keys),
               "tasks": num_task, "bn_undone_leaves": sorted(undone),
               "bn_undone_max_abs_diff": undone_diff,
               "card_losses": card_losses, "cpu_losses": cpu_losses,
               "loss_rel_diffs": loss_rel, "grad_rel_err": errs[worst],
               "grad_worst_leaf": worst, "grad_leaves": len(errs), "zero_grad_rel_size": zero,
               "dense_max_abs_diff": dense.max().item(),
               "dense_elements_beyond_atol": int((dense > DENSE_ATOL).sum().item()),
               "table_max_abs_diff": tables.max().item(),
               "table_elements_beyond_atol": int((tables > TABLE_ATOL).sum().item()),
               "table_elements": tables.numel(), "running_stats_max_rel_diff": stats_rel,
               "running_stats_rtol": RANK_STATS_RTOL, "loss_rtol": LOSS_RTOL,
               "zero_grad_rel": RANK_ZERO_GRAD_REL, "dense_atol": DENSE_ATOL,
               "table_atol": TABLE_ATOL, **gates, "seconds": time.perf_counter() - t_start}
    if (max(loss_rel) > LOSS_RTOL or errs[worst] > gates["grad_rel_tol"]
            or max(zero.values(), default=0.0) > RANK_ZERO_GRAD_REL
            or stats_rel > RANK_STATS_RTOL
            or summary["dense_elements_beyond_atol"] > gates["dense_handful"]
            or summary["table_elements_beyond_atol"] > gates["table_handful"]
            or max(dense.max().item(), tables.max().item(), undone_diff) > 2 * LR):
        raise RuntimeError(f"the card's {name} training differs from the CPU's: {summary}")
    return summary


def phase_ranking_zoo(tmp: str, devices=("cuda", "cpu")) -> dict:
    """The ranking zoo at the bench's width, model by model (RANK_ZOO):
    checkpoint, serving, fit, card against CPU; WDL also its serving and
    training profiles, the bench's REQUESTS, a fit of EPOCHS x TRAIN_BATCHES
    with validation, STD_STEPS standard steps and three card-against-CPU
    fused steps at full width.  Emits each phase; returns the summaries by
    model."""
    device = devices[0]
    zoo = {}
    for name, seed in RANK_ZOO:
        full = name == "WDL"
        label = name.lower()
        t0 = time.perf_counter()
        m_path = os.path.join(tmp, f"{label}.ckpt")
        m_enc_dict = write_rank_checkpoint(m_path, name, seed)
        emit({"phase": f"{label}_checkpoint", "seconds": time.perf_counter() - t0,
              "bytes": os.path.getsize(m_path)})
        serving, model, score, profiled = phase_serving(
            m_path, m_enc_dict, device, name, REQUESTS if full else RANK_REQUESTS, seed + 2,
            f"{label}_serving", 3 if full else RANK_CPU_CHECKS)
        emit(serving)
        if full and device == "cuda":
            emit(phase_profile(model, profiled, f"{label}_profile"))
        del model
        m_ckpt = os.path.join(tmp, f"{label}_ckpt")
        training, trainer, loader = phase_training(
            m_path, m_enc_dict, score, m_ckpt, device, name,
            EPOCHS if full else RANK_FIT_EPOCHS, TRAIN_BATCHES if full else RANK_FIT_BATCHES,
            VALID_BATCHES if full else 0, STD_STEPS if full else 0, seed + 4,
            f"{label}_training")
        emit(training)
        zoo[name] = {"serving": serving, "training": training}
        if full:
            batches = [b for _, b in zip(range(TRAIN_PROFILED), loader)]
            zoo[name]["card_vs_cpu"] = phase_card_vs_cpu(
                m_path, m_enc_dict, batches[:CPU_STEPS], devices, name, f"{label}_card_vs_cpu")
            emit(zoo[name]["card_vs_cpu"])
            if device == "cuda":
                emit(phase_train_profile(trainer, batches, f"{label}_train_profile"))
            del batches
        else:
            zoo[name]["card_vs_cpu"] = phase_rank_card_vs_cpu(name, seed + 6, devices)
            emit(zoo[name]["card_vs_cpu"])
        del trainer, loader
        shutil.rmtree(m_ckpt, ignore_errors=True)
        os.remove(m_path)
        if device == "cuda":
            torch.cuda.empty_cache()
    return zoo


# ------------------------------------------------------ the session-graph family
# at bench.py's sequence width (bench.py:36: 1,000,000 items, L = 50, D = 64,
# batch 1024) with each JAX class's defaults
# (rec_pangu_tpu/models/sequence/srgnn.py): one SR-GNN step; GCSAN's causal
# encoder of SASRec's shape (2 blocks of 4 heads, inner 32, gelu, eps 1e-3,
# dropout 0.1) and weight 0.1; NISER's item dropout 0.1 and learned
# positions.  A training batch carries the trainer's host session graph, so
# the fused step's ids are its nodes; serving and eval build the graph on
# the card.  K1 a request, step and eval batch (of the nodes), K3 a fused
# step, K2 a standard step; GCSAN also K4f a request, step and eval batch
# and K4b a fused step.  SRGNN in full (the bench's leg), the others short.
GRAPH_BASE = {"embedding_dim": SEQ_DIM, "max_length": SEQ_L, "item_col": "item_id"}
GRAPH_ZOO = (("SRGNN", SEED + 600), ("GCSAN", SEED + 610), ("NISER", SEED + 620))
GRAPH_KERNELS = {"SRGNN": (("embedding_lookup",), ("fused_adam",)),
                 "GCSAN": (("embedding_lookup", "fused_encoder"),
                           ("fused_adam", "fused_encoder_bwd")),
                 "NISER": (("embedding_lookup",), ("fused_adam",))}
GRAPH_EPOCHS, GRAPH_SHORT_BATCHES = 2, 4  # the short fits: 2 x 4, each batch seen again


def phase_graph_zoo(tmp: str, devices=("cuda", "cpu")) -> dict:
    """The session-graph family at bench.py's sequence width, model by
    model (GRAPH_ZOO): checkpoint, retrieval serving (K1 of the nodes a
    request; GCSAN's K4f too), eval on the bundled data card against CPU,
    the fused fit (asserted, on the trainer's host graph), card against CPU
    (three fused steps at a cut corpus).  SRGNN in full: SEQ_REQUESTS
    requests, SEQ_CPU_CHECKS whole requests against the CPU, profiles,
    GRAPH_EPOCHS x FIT_TRAIN_BATCHES and IOC_STD_STEPS standard steps; the
    others CLASSIC_REQUESTS requests (their first IOC_CPU_USERS histories
    against the CPU) and GRAPH_EPOCHS x GRAPH_SHORT_BATCHES.  Emits each
    phase; returns the summaries by model."""
    device = devices[0]
    zoo = {}
    for name, seed in GRAPH_ZOO:
        full = name == "SRGNN"
        label = name.lower()
        per_batch, per_step = GRAPH_KERNELS[name]
        t0 = time.perf_counter()
        m_path = os.path.join(tmp, f"{label}.ckpt")
        m_enc_dict = write_model_checkpoint(m_path, name, GRAPH_BASE, seed)
        emit({"phase": f"{label}_checkpoint", "seconds": time.perf_counter() - t0,
              "bytes": os.path.getsize(m_path)})
        m_serving, m_model, m_profiled = phase_model_serving(
            m_path, m_enc_dict, name, GRAPH_BASE, per_batch, seed + 2, device,
            requests=SEQ_REQUESTS if full else CLASSIC_REQUESTS, label=label,
            cpu_users=SEQ_BATCH if full else IOC_CPU_USERS)
        emit(m_serving)
        if full and device == "cuda":
            emit(phase_seq_profile(m_model, m_profiled, f"{label}_profile"))
        del m_model
        torch.cuda.empty_cache()
        emit(phase_seq_eval(device, name, GRAPH_BASE, per_batch, label))
        m_ckpt = os.path.join(tmp, f"{label}_ckpt")
        m_training, m_loader = phase_model_training(
            m_path, m_enc_dict, m_ckpt, name, GRAPH_BASE, per_step, per_batch, seed + 3,
            IOC_STD_STEPS if full else 0, GRAPH_EPOCHS, device, label,
            FIT_TRAIN_BATCHES if full else GRAPH_SHORT_BATCHES)
        emit(m_training)
        zoo[name] = {"serving": m_serving, "training": m_training}
        torch.cuda.empty_cache()
        emit(phase_model_card_vs_cpu(name, GRAPH_BASE, devices, SEQ_LOSS_RTOL, label))
        if full and device == "cuda":
            m_batches = [b for _, b in zip(range(CLASSIC_PROFILED), m_loader)]
            emit(phase_seq_train_profile(
                m_path, m_enc_dict, m_batches, m_ckpt,
                functools.partial(load_seq_model, name=name, config=GRAPH_BASE),
                f"{label}_train_profile"))
            del m_batches
        del m_loader
        shutil.rmtree(m_ckpt, ignore_errors=True)
        os.remove(m_path)
        torch.cuda.empty_cache()
    return zoo


# ------------------------------------------------------ the multi-task zoo
# at the bench's width (bench.py:107-110: MMOE with num_task=2 and the class's
# other defaults) with each JAX class's defaults
# (rec_pangu_tpu/models/multi_task/*.py): D = 40 (AITM 32), two tasks, towers
# (128, 64) with dropout 0.2 and no activation, 3 experts of 128 (MMOE,
# OMOE, MLMMOE), ESSM's sparse-only towers, AITM's (400, 400, 400) towers
# with dropout 0.1.  One xavier-initialized table each: K1 a request, step
# and eval batch, K3 a fused step, K2 a standard step.  MMOE in full (the
# bench's leg), the others as the ranking zoo's short legs.
MTL_ZOO = (("MMOE", SEED + 500), ("ShareBottom", SEED + 510), ("ESSM", SEED + 520),
           ("OMOE", SEED + 530), ("MLMMOE", SEED + 540), ("AITM", SEED + 550))
MTL_NAMES = tuple(name for name, _ in MTL_ZOO)
MTL_TASKS, MTL_DIM = 2, 40
# MMOE's card against CPU at full width: the xavier table (std
# sqrt(2 / (100,001 + 40)) = 0.0045) takes gradients of 1e-9 to 1e-7 a row
# through the BatchNorms, of the size of Adam's eps (1e-8), where its first
# step lr g / (|g| + eps) turns a rounding of g into a move of up to a few
# 1e-5: past TABLE_ATOL on more elements than RANK_TABLE_HANDFUL allows
# (first card run: 1,489 of 64,225,280, the largest 6.07e-5, while the
# table's gradient agreed within 8.0e-6 of its largest entry), none near 2 lr
MTL_FULL_LOOSER = {"table_handful": 4096}


def phase_mtl_serving(path: str, enc_dict: dict, name: str, requests: int, seed: int,
                      cpu_checks: int, device: str = "cuda"):
    """``requests`` timed requests of 8192 rows of the multi-task model
    ``name`` (after WARMUP) through RankTrainer(num_task=2).load_model and
    its ``_predict`` (the multi-task serving path: neither package's
    ranking scorer serves a multi-task model), K1 once a request; the first
    ``cpu_checks`` held against the same model on the CPU within
    SERVING_ATOL; evaluate_model (``test_task{i}_*``) on a labelled set
    drawn from the model's own predictions."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    model = load_model(path, enc_dict, device, name)
    trainer = RankTrainer(num_task=MTL_TASKS, device=device)
    cpu_model = load_model(path, enc_dict, "cpu", name)
    cpu_trainer = RankTrainer(num_task=MTL_TASKS, device="cpu")

    def score(req):
        return trainer._predict(model, req, dev)

    setup_s = time.perf_counter() - t0
    reqs = make_requests(WARMUP + requests, seed)
    phase = f"{name.lower()}_serving"
    # the main path: every count is 0 just before it and read just after
    reset_launches()
    preds, latencies = [], []
    for i, req in enumerate(reqs):
        t0 = time.perf_counter()
        preds.append(score(req))
        if i >= WARMUP:
            latencies.append(time.perf_counter() - t0)
    launches = read_launches()
    require_launches(launches, {"embedding_lookup": len(reqs)}, phase)
    max_err = 0.0
    for req, pred in zip(reqs[:cpu_checks], preds[:cpu_checks]):
        if (pred.shape != (BATCH, MTL_TASKS) or not np.all(np.isfinite(pred))
                or pred.min() < 0 or pred.max() > 1):
            raise RuntimeError(f"bad {name} predictions: shape {pred.shape}")
        want = cpu_trainer._predict(cpu_model, req, torch.device("cpu"))
        max_err = max(max_err, float(np.abs(pred - want).max()))
    if max_err > SERVING_ATOL:
        raise RuntimeError(f"card {name} predictions differ from the CPU's by {max_err} "
                           f"> {SERVING_ATOL}")
    del cpu_model
    metrics = trainer.evaluate_model(model, labelled_loader(score, 4, seed + 3))
    if not all(0.0 <= metrics[f"test_task{t}_roc_auc_score"] <= 1.0
               and math.isfinite(metrics[f"test_task{t}_log_loss"])
               for t in range(1, MTL_TASKS + 1)):
        raise RuntimeError(f"bad {name} metrics {metrics}")
    summary = {
        "phase": phase, "model": name, "batch": BATCH, "fields": FIELDS, "vocab": VOCAB,
        "dense": DENSE, "tasks": MTL_TASKS, "embedding_dim": model.embedding_dim,
        "table_rows": padded_rows(model.spec.total_rows), "tables": num_tables(model),
        "requests": requests, "warmup": WARMUP, "launches": launches,
        "cpu_checked_requests": cpu_checks, "max_abs_err_vs_cpu": max_err,
        "atol": SERVING_ATOL, "p50_ms": statistics.median(latencies) * 1e3,
        "p90_ms": float(np.percentile(latencies, 90)) * 1e3,
        "examples_per_s": requests * BATCH / sum(latencies), "eval": metrics,
        "setup_s": setup_s,
    }
    return summary, model, score, reqs[WARMUP:WARMUP + PROFILED]


def phase_mtl_zoo(tmp: str, devices=("cuda", "cpu")) -> dict:
    """The multi-task zoo at the bench's width, model by model (MTL_ZOO):
    checkpoint, serving, fit, card against CPU.  MMOE also its serving and
    training profiles, the bench's REQUESTS, a fit of EPOCHS x
    TRAIN_BATCHES with validation (each task's AUC), STD_STEPS standard
    steps and three card-against-CPU fused steps at full width, dropout on;
    the others RANK_REQUESTS, a fit of RANK_FIT_EPOCHS x RANK_FIT_BATCHES
    and three steps at 16 x RANK_CPU_VOCAB ids.  Every fit asserts the fused
    step (``phase_training``).  Emits each phase; returns the summaries by
    model."""
    device = devices[0]
    zoo = {}
    for name, seed in MTL_ZOO:
        full = name == "MMOE"
        label = name.lower()
        t0 = time.perf_counter()
        m_path = os.path.join(tmp, f"{label}.ckpt")
        m_enc_dict = write_rank_checkpoint(m_path, name, seed)
        emit({"phase": f"{label}_checkpoint", "seconds": time.perf_counter() - t0,
              "bytes": os.path.getsize(m_path)})
        serving, model, score, profiled = phase_mtl_serving(
            m_path, m_enc_dict, name, REQUESTS if full else RANK_REQUESTS, seed + 2,
            3 if full else RANK_CPU_CHECKS, device)
        emit(serving)
        if full and device == "cuda":
            emit(phase_profile(model, profiled, f"{label}_profile", score))
        m_ckpt = os.path.join(tmp, f"{label}_ckpt")
        training, trainer, loader = phase_training(
            m_path, m_enc_dict, score, m_ckpt, device, name,
            EPOCHS if full else RANK_FIT_EPOCHS, TRAIN_BATCHES if full else RANK_FIT_BATCHES,
            VALID_BATCHES if full else 0, STD_STEPS if full else 0, seed + 4,
            f"{label}_training", MTL_TASKS)
        emit(training)
        del model, score
        zoo[name] = {"serving": serving, "training": training}
        if full:
            zoo[name]["card_vs_cpu"] = phase_rank_card_vs_cpu(
                name, seed + 6, devices, VOCAB, BATCH, f"{label}_card_vs_cpu", MTL_FULL_LOOSER)
            emit(zoo[name]["card_vs_cpu"])
            if device == "cuda":
                batches = [b for _, b in zip(range(TRAIN_PROFILED), loader)]
                emit(phase_train_profile(trainer, batches, f"{label}_train_profile"))
                del batches
        else:
            zoo[name]["card_vs_cpu"] = phase_rank_card_vs_cpu(name, seed + 6, devices)
            emit(zoo[name]["card_vs_cpu"])
        del trainer, loader
        shutil.rmtree(m_ckpt, ignore_errors=True)
        os.remove(m_path)
        if device == "cuda":
            torch.cuda.empty_cache()
    return zoo


# ------------------------------------------------------ K1, K2 and K3 at other widths
def wdl_shared_sort(id_sets, lr_rows, lr_state, hyper, gen) -> dict:
    """WDL's fused step updates its LR table ``lr_state`` ([V, 1]) and its
    [V, DIM] embedding on one sort of the ids (``sort_for``, then
    ``update_sorted`` a table): the same bits as one ``planned_adam_update``
    a table, and its time beside theirs."""
    num_rows = lr_state[0].shape[0]
    emb_rows = torch.randn(lr_rows.shape[0], DIM, generator=gen, device="cuda") * 1e-3
    emb_state = adam_state(num_rows, DIM, gen)
    states = [(lr_rows, lr_state), (emb_rows, emb_state)]

    def shared(ids, tables):
        plan = adam.sort_for(ids, num_rows)
        for rows, state in tables:
            adam.update_sorted(plan, rows, *state, hyper)

    def separate(ids, tables):
        for rows, state in tables:
            adam.planned_adam_update(ids, rows, *state, hyper)

    copies = [[(rows, [t.clone() for t in state]) for rows, state in states] for _ in range(2)]
    shared(id_sets[0], copies[0])
    separate(id_sets[0], copies[1])
    for (_, a), (_, b) in zip(*copies):
        for x, y in zip(a, b):
            require_equal(x, y, "WDL's tables on one sort against one sort a table")
    del copies
    return {"wdl_shared_sort_ms": median_ms([lambda x=x: shared(x, states) for x in id_sets]),
            "wdl_sort_a_table_ms": median_ms([lambda x=x: separate(x, states)
                                              for x in id_sets])}


def phase_width_tables(bandwidth: float, dim: int, seed: int, with_lookup: bool) -> dict:
    """K3 and K2 (and K1 with ``with_lookup``) at the bench table's rows and
    width ``dim``: [padded_rows(1,600,016), dim] = [1,605,632, dim] (the
    LR tables' D = 1, the multi-task family's D = 40), the ids of one
    8192-row batch of 16 fields (131,072), against their plain versions (K3
    bit-equal on rows hit once, within the rounding bound elsewhere; K2
    within its sum bound, run twice for the same bits; K1 bit-equal), each
    timed beside its plain version and library call."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    num_rows = padded_rows(FIELDS * (VOCAB + 1))
    offsets = torch.arange(FIELDS, device="cuda", dtype=torch.int32) * (VOCAB + 1)
    sparse_sets = [torch.randint(0, VOCAB + 1, (BATCH, FIELDS), generator=gen, device="cuda",
                                 dtype=torch.int32) for _ in range(ID_SETS)]
    id_sets = [lookup.fused_ids(x, offsets) for x in sparse_sets]
    cot = torch.randn(BATCH * FIELDS, dim, generator=gen, device="cuda") * 1e-3
    ids, n = id_sets[0], id_sets[0].numel()
    long_sets = [x.long() for x in id_sets]
    what = f"[{num_rows}, {dim}] table"

    state = adam_state(num_rows, dim, gen)
    adam_err = 0.0
    for t in (1, 2, 3):
        hyper = adam.adam_hyper(t, LR)
        adam_err = max(adam_err, check_adam_step(id_sets[t - 1], cot, state, hyper,
                                                 f"{what}, step {t}"))
        adam.planned_adam_update(id_sets[t - 1], cot, *state, hyper)
    p, m, v = state
    hyper = adam.adam_hyper(4, LR)
    lib_p = torch.nn.Parameter(p.clone())
    lib_p.grad = torch.zeros_like(p)
    lib_opt = torch.optim.Adam([lib_p], lr=LR, betas=(0.9, 0.999), eps=1e-8, fused=True,
                               capturable=True)

    def library(x):
        lib_p.grad.zero_().index_add_(0, x, cot)
        lib_opt.step()

    # p, m, v read and written; rows and ids read
    adam_bytes = 6 * num_rows * dim * 4 + n * dim * 4 + n * 4
    sorted_sets = [adam.sort_for(x, num_rows) for x in id_sets]
    k3 = {"name": "fused_adam", "shape": [num_rows, dim], "ids": n, "max_abs_err": adam_err,
          "ms": median_ms([lambda x=x: adam.planned_adam_update(x, cot, p, m, v, hyper)
                           for x in id_sets]),
          "kernel_only_ms": median_ms([lambda s=s: adam.launch(s, cot, p, m, v, hyper)
                                       for s in sorted_sets]),
          "sort_ms": median_ms([lambda x=x: grad.sort_ids(x, num_rows) for x in id_sets]),
          "plain_ms": median_ms([lambda x=x: adam.planned_adam_update_reference(
              x, cot, p, m, v, hyper) for x in id_sets]),
          "bound_ms": adam_bytes / bandwidth * 1e3, "bound_by": "bytes", "bytes": adam_bytes,
          "library_ms": median_ms([lambda x=x: library(x) for x in long_sets]),
          "library": "index_add_ into a zeroed gradient, then torch.optim.Adam(fused=True)",
          "tile_plan": adam.tile_plan(num_rows, dim, sms())._asdict()}
    k3["bound_share"] = k3["bound_ms"] / k3["ms"]
    if dim == 1:
        k3.update(wdl_shared_sort(id_sets, cot, state, hyper, gen))

    out = grad.table_grad(ids, cot, num_rows)
    require_equal(grad.table_grad(ids, cot, num_rows), out, f"{what}, run twice")
    bound, _ = sum_tolerance(ids, cot, num_rows)
    grad_err = require_within(out, grad.table_grad_reference(ids, cot, num_rows), bound,
                              f"{what} x {n} ids")
    lib = torch.zeros(num_rows, dim, device="cuda")
    grad_bytes = num_rows * dim * 4 + n * dim * 4 + n * 4  # grad written; rows, ids read
    k2 = {"name": "embedding_grad", "shape": [num_rows, dim], "ids": n,
          "max_abs_err": grad_err,
          "ms": median_ms([lambda x=x: grad.table_grad(x, cot, num_rows) for x in id_sets]),
          "plain_ms": median_ms([lambda x=x: grad.table_grad_reference(x, cot, num_rows)
                                 for x in id_sets]),
          "bound_ms": grad_bytes / bandwidth * 1e3, "bound_by": "bytes", "bytes": grad_bytes,
          "library_ms": median_ms([lambda x=x: lib.zero_().index_add_(0, x, cot)
                                   for x in long_sets]),
          "library": f"torch.zeros(V, {dim}).index_add_(0, ids, rows)"}
    row = {"phase": f"kernel_d{dim}", "fused_adam": k3, "embedding_grad": k2}
    if with_lookup:
        table = p  # the table the Adam steps left
        got = lookup.fused_embedding_lookup(table, sparse_sets[0], offsets)
        require_equal(got, lookup.fused_embedding_lookup_reference(table, sparse_sets[0],
                                                                   offsets), f"{what} lookup")
        moved = 2 * n * dim * 4 + n * 4 + FIELDS * 4  # rows read + written, ids, offsets
        row["embedding_lookup"] = {
            "name": "embedding_lookup", "shape": [num_rows, dim], "ids": n,
            "max_abs_err": 0.0,
            "ms": median_ms([lambda x=x: lookup.fused_embedding_lookup(table, x, offsets)
                             for x in sparse_sets]),
            "plain_ms": median_ms([lambda x=x: lookup.fused_embedding_lookup_reference(
                table, x, offsets) for x in sparse_sets]),
            "bound_ms": moved / bandwidth * 1e3, "bound_by": "bytes", "bytes": moved,
            "library_ms": median_ms([lambda x=x: torch.nn.functional.embedding(x, table)
                                     for x in long_sets]),
            "library": "F.embedding over the fused ids"}
    return row


# ------------------------------------------------------ shapes past the kernels' limits
# Each runs the plain version on the card (chosen by the shape before any
# launch), held against the CPU: 256 histories of a 100,000-item corpus.
PAST_LIMIT_USERS = 256
# IOCRec past its limits runs plain products on the card (cuBLAS) and on the
# CPU, which round apart; besides the local encoder's relu, the K-max CE's
# best interest k* is a kink: where two interests nearly tie, the card and
# the CPU pick different ones and the gradient flows to another interest.
# So every leaf's first gradient is held as the relu's path is, and more
# Adam first steps flip (card runs at 256 and 128 histories: K=8 up to
# 5.5e-3 of a leaf on disentangle_encoder.W.bias and 26 dense elements 2 lr
# apart; L=80 19 elements, 2.0e-6 off the relu's path)
PAST_IOC_GRAD_REL_TOL = IOC_KINK_GRAD_REL_TOL
PAST_IOC_DENSE_HANDFUL = 64
PAST_LIMITS = (
    ("sasrec_len100", "SASRec", {**SEQ_CONFIG, "max_length": 100}, ("fused_encoder",),
     ("embedding_lookup",), ()),
    ("sasrec_dim256", "SASRec", {**SEQ_CONFIG, "embedding_dim": 256}, ("fused_encoder",),
     ("embedding_lookup",), ()),
    ("iocrec_k8", "IOCRec", {**IOC_CONFIG, "K": 8}, ("multimax_ce",),
     ("embedding_lookup", "fused_encoder", "global_attn"),
     ("fused_encoder_bwd", "global_attn_bwd")),
    ("iocrec_len80", "IOCRec", {**IOC_CONFIG, "max_length": 80},
     ("fused_encoder", "global_attn"), ("embedding_lookup",),
     ("multimax_ce", "multimax_ce_bwd")),
)


def past_limit_requests(length: int, seed: int, count: int = 2):
    """``count`` requests of PAST_LIMIT_USERS histories of ``length``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        lengths = rng.integers(1, length + 1, PAST_LIMIT_USERS)
        mask = (np.arange(length)[None, :] < lengths[:, None]).astype(np.float32)
        items = rng.integers(1, SEQ_CPU_VOCAB, (PAST_LIMIT_USERS, length))
        out.append({"hist_item_list": np.where(mask > 0, items, 0).astype(np.int32),
                    "hist_mask_list": mask})
    return out


def phase_past_limits(devices=("cuda", "cpu")) -> dict:
    """SASRec at max_len 100 and at hidden size 256 (past K4f's L <= 64 and
    D <= 128), IOCRec with K = 8 (past K5's K <= 4) and at max_len 80 (past
    K4f's and K6's L <= 64): two retrieval requests and two fused steps
    each, on the card and the CPU from the same weights.  The kernels whose
    limits a case passes launch 0 times and their calls count on the plain
    route; the others launch as on their bench paths.  Retrieval: user
    embeddings within USER_EMB_ATOL, top-k as ``compare_topk``; training as
    the sequence card-against-CPU legs (``require_card_like_cpu``)."""
    t_start = time.perf_counter()
    device = devices[0]
    enc_dict = {"item_id": {"vocab_size": SEQ_CPU_VOCAB}}
    out = {"phase": "past_limits", "users": PAST_LIMIT_USERS, "vocab": SEQ_CPU_VOCAB}
    for label, name, config, past, per_request, per_step in PAST_LIMITS:
        length = config["max_length"]
        seed = SEED + 440 + len(out)
        models = [port.get_model(name)(enc_dict=enc_dict, config=config, seed=seed)
                  .to(dev).eval() for dev in devices]
        retrieve = make_retrieval_scorer(models[0], topk=SEQ_TOPK, device=device)
        cpu_retrieve = make_retrieval_scorer(models[1], topk=SEQ_TOPK + 1, device="cpu")
        requests = past_limit_requests(length, seed + 1)
        reset_launches()
        answers = [retrieve(req) for req in requests]
        serving = read_launches()
        # retrieval runs the encoders, not the K-max CE (a training loss)
        plain = {f"{k}_plain": len(requests) for k in past
                 if k in ("fused_encoder", "global_attn")}
        require_launches(serving, {**{k: len(requests) for k in per_request}, **plain},
                         f"{label} retrieval")
        emb_err, differing = 0.0, 0
        for req, (scores, ids) in zip(requests, answers):
            with torch.inference_mode():
                embs = [m(m.upload_batch(req, torch.device(d)))["user_emb"].cpu()
                        for d, m in zip(devices, models)]
            emb_err = max(emb_err, (embs[0] - embs[1]).abs().max().item())
            cpu_scores, cpu_ids = cpu_retrieve(req)
            differing += compare_topk(ids, scores, cpu_ids, cpu_scores)
        if emb_err > USER_EMB_ATOL:
            raise RuntimeError(f"{label}: card user_emb differs from the CPU's by {emb_err}")
        del models, retrieve, cpu_retrieve

        trainer = SequenceTrainer(device="cpu")
        trainer.model = port.get_model(name)(enc_dict=enc_dict, config=config)
        loader = seq_train_loader(2, seed + 2, SEQ_CPU_VOCAB, PAST_LIMIT_USERS)
        batches = []
        for b in loader:  # histories of the case's length
            wide = np.resize(b["hist_item_list"], (PAST_LIMIT_USERS, length)).astype(np.int32)
            mask = np.resize(b["hist_mask_list"], (PAST_LIMIT_USERS, length))
            batches.append(trainer._attach_host_keys(
                {**b, "hist_item_list": wide, "hist_mask_list": mask}))
        reset_launches()
        kink = ((lambda k: k.startswith(IOC_KINK_PATH)) if name == "IOCRec"
                else (lambda k: False))
        leg = card_vs_cpu_leg(name, config, batches, LR, devices, seed, kink)
        training = read_launches()
        steps = len(batches)
        require_launches(training, {"fused_adam": steps,
                                    **{k: steps for k in per_request + per_step},
                                    **{f"{k}_plain": steps * (2 if k == "multimax_ce" else 1)
                                       for k in past if not k.endswith("_bwd")}},
                         f"{label} fused steps")
        summary = {"model": name, "config": config, "past": list(past),
                   "retrieval_launches": serving, "user_emb_max_abs_err_vs_cpu": emb_err,
                   "topk_positions_differing_at_ties": differing,
                   "training_launches": training, "training": leg}
        if name == "IOCRec":  # every leaf behind a kink: see PAST_IOC_GRAD_REL_TOL
            require_card_like_cpu(leg, IOC_LATER_LOSS_RTOL, IOC_KINK_GRAD_REL_TOL, summary,
                                  PAST_IOC_GRAD_REL_TOL, PAST_IOC_DENSE_HANDFUL)
        else:
            require_card_like_cpu(leg, IOC_LATER_LOSS_RTOL, IOC_GRAD_REL_TOL, summary)
        out[label] = summary
        if device == "cuda":
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    return out


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

    bandwidth, fp32, tf32 = peak_bandwidth(kind), peak_fp32(kind), peak_tf32(kind)
    rows = [phase_kernel(bandwidth), phase_table_grad(bandwidth),
            phase_sorted_accumulate(bandwidth), phase_fused_adam(bandwidth),
            phase_fused_encoder(bandwidth, fp32), phase_fused_encoder_bwd(bandwidth, fp32),
            *phase_global_attn(bandwidth, fp32), *phase_multimax_ce(bandwidth, fp32, tf32)]
    for row in rows:
        emit({"phase": "kernel", **row})
    d1 = phase_width_tables(bandwidth, 1, SEED + 430, with_lookup=False)
    emit(d1)
    d40 = phase_width_tables(bandwidth, MTL_DIM, SEED + 435, with_lookup=True)
    emit(d40)
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
        torch.cuda.empty_cache()
        zoo = phase_ranking_zoo(tmp)
        mtl_zoo = phase_mtl_zoo(tmp)

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
            emit(phase_model_card_vs_cpu(name, config))
            m_batches = [b for _, b in zip(range(CONTRA_PROFILED), m_loader)]
            emit(phase_seq_train_profile(
                m_path, m_enc_dict, m_batches, m_ckpt,
                functools.partial(load_seq_model, name=name, config=config),
                f"{name.lower()}_train_profile"))
            del m_loader, m_batches
            shutil.rmtree(m_ckpt)
            os.remove(m_path)
            torch.cuda.empty_cache()

        # the classic zoo (GRU4Rec in full), then ContraRec's other encoders:
        # K1 a request, step and eval batch, K3 a fused step, K2 (GRU4Rec's
        # standard steps) and K7 (the device views) a standard step
        classic = {}
        for name, config, seed in CLASSIC + tuple(
                ("ContraRec", {**CONTRA_CONFIG, "encoder_name": enc}, seed)
                for enc, seed in CONTRA_ENCODERS):
            full = name == "GRU4Rec"
            contra = name == "ContraRec"
            label = f"contrarec_{config['encoder_name'].lower()}" if contra else name.lower()
            t0 = time.perf_counter()
            m_path = os.path.join(tmp, f"{label}.ckpt")
            m_enc_dict = write_model_checkpoint(m_path, name, config, seed)
            emit({"phase": f"{label}_checkpoint", "seconds": time.perf_counter() - t0,
                  "bytes": os.path.getsize(m_path)})
            m_serving, m_model, m_profiled = phase_model_serving(
                m_path, m_enc_dict, name, config, CLASSIC_KERNELS, seed + 2,
                requests=SEQ_REQUESTS if full else CLASSIC_REQUESTS, label=label)
            emit(m_serving)
            if full:
                emit(phase_seq_profile(m_model, m_profiled, f"{label}_profile"))
            del m_model
            torch.cuda.empty_cache()
            if not contra:
                emit(phase_seq_eval("cuda", name, config, CLASSIC_KERNELS, label))
            m_ckpt = os.path.join(tmp, f"{label}_ckpt")
            m_training, m_loader = phase_model_training(
                m_path, m_enc_dict, m_ckpt, name, config, ("fused_adam",), CLASSIC_KERNELS,
                seed + 3, IOC_STD_STEPS if full else 0, CLASSIC_EPOCHS, label=label)
            emit(m_training)
            classic[label] = {"serving": m_serving, "training": m_training}
            torch.cuda.empty_cache()
            if contra:
                classic[label]["device_aug"] = phase_device_aug(
                    m_path, m_enc_dict, config=config, kernels=CLASSIC_KERNELS, label=label)
                emit(classic[label]["device_aug"])
            else:
                with torch_default_tf32():
                    emit(phase_model_card_vs_cpu(name, config, later_rtol=SEQ_LOSS_RTOL,
                                                 label=label))
            if full:
                m_batches = [b for _, b in zip(range(CLASSIC_PROFILED), m_loader)]
                emit(phase_seq_train_profile(
                    m_path, m_enc_dict, m_batches, m_ckpt,
                    functools.partial(load_seq_model, name=name, config=config),
                    f"{label}_train_profile"))
                emit(phase_gru_share(m_path, m_enc_dict, m_batches, config))
                del m_batches
            del m_loader
            shutil.rmtree(m_ckpt)
            os.remove(m_path)
            torch.cuda.empty_cache()

        graph_zoo = phase_graph_zoo(tmp)

    # shapes past the kernels' limits: the plain versions on the card
    emit(phase_past_limits())

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
    # the radix sort's launches on the same runs: once before each K2, K7 and K3
    sort_launches = {"embedding_grad": training["standard_launches"]["radix_sort"],
                     "embedding_grad_sorted": device_aug["launches"]["radix_sort"],
                     "fused_adam": training["launches"]["radix_sort"]}
    for line in lines:
        if line["name"] in sort_launches:
            line["sort_launches"] = sort_launches[line["name"]]
        if line["name"] in ("fused_adam", "fused_encoder"):
            line["launches_seq_training"] = seq_training["launches"][line["name"]]
        if line["name"] in ("embedding_lookup", "fused_adam", "fused_encoder",
                            "fused_encoder_bwd", "global_attn"):
            line["launches_iocrec_training"] = ioc_training["launches"][line["name"]]
        if line["name"] == "fused_encoder_bwd":  # its launches' times and the forward's stores
            row = next(r for r in rows if r["name"] == "fused_encoder_bwd")
            line.update({k: row[k] for k in (
                "parts", "forward_ms", "forward_no_save_ms", "saved_bytes", "fwd_bwd_ms",
                "library_fwd_bwd_ms", "iocrec_shape_ms", "iocrec_shape_parts",
                "iocrec_shape_library_ms", "iocrec_shape_bound_ms")})
        if line["name"] == "multimax_ce_bwd":  # its launches' times
            line["parts"] = next(r for r in rows if r["name"] == "multimax_ce_bwd")["parts"]
        if line["name"] in BERT_KERNELS + BERT_STEP_KERNELS:
            for name, m_training in contrastive.items():
                line[f"launches_{name.lower()}_training"] = m_training["launches"][line["name"]]
        # the classic models' and ContraRec's other encoders' paths
        for label, legs in classic.items():
            if line["name"] == "embedding_lookup":
                line[f"launches_{label}_serving"] = legs["serving"]["launches"][line["name"]]
            if line["name"] in ("embedding_lookup", "fused_adam"):
                line[f"launches_{label}_training"] = legs["training"]["launches"][line["name"]]
            if line["name"] == "embedding_grad" and "standard_launches" in legs["training"]:
                line[f"launches_{label}_standard"] = (
                    legs["training"]["standard_launches"]["embedding_grad"])
            if line["name"] == "embedding_grad_sorted" and "device_aug" in legs:
                line[f"launches_{label}_device_aug"] = (
                    legs["device_aug"]["launches"]["embedding_grad"])
        # the ranking and multi-task zoos' paths: K1 a table a request, step and
        # eval batch, K3 a table a fused step, K2 a table a standard step (WDL's,
        # MMOE's)
        for name, legs in list(zoo.items()) + list(mtl_zoo.items()):
            label = name.lower()
            if line["name"] == "embedding_lookup":
                line[f"launches_{label}_serving"] = legs["serving"]["launches"][line["name"]]
            if line["name"] in ("embedding_lookup", "fused_adam"):
                line[f"launches_{label}_training"] = legs["training"]["launches"][line["name"]]
            if line["name"] == "fused_adam":  # one sort a step for each table height
                line[f"sort_launches_{label}_training"] = (
                    legs["training"]["launches"]["radix_sort"])
            if line["name"] == "embedding_grad" and "standard_launches" in legs["training"]:
                line[f"launches_{label}_standard"] = (
                    legs["training"]["standard_launches"]["embedding_grad"])
        # the session-graph family's paths: K1 of the nodes a request, step and
        # eval batch, K3 a fused step, K2 a standard step (SRGNN's); GCSAN's
        # K4f a request, step and eval batch and K4b a fused step
        for name, legs in graph_zoo.items():
            label = name.lower()
            for leg, counts in (("serving", legs["serving"]["launches"]),
                                ("training", legs["training"]["launches"]),
                                ("standard", legs["training"].get("standard_launches", {}))):
                if counts.get(line["name"]):
                    line[f"launches_{label}_{leg}"] = counts[line["name"]]
        if line["name"] in ("fused_adam", "embedding_grad"):  # at the LR table's shape, D = 1
            line["d1"] = {k: v for k, v in d1[line["name"]].items() if k != "name"}
        if line["name"] in d40:  # at the multi-task family's width, D = 40
            line["d40"] = {k: v for k, v in d40[line["name"]].items() if k != "name"}
    emit({"kernels": lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
