"""K2/K7, the table gradient, and its radix sort alone on one CUDA card.

Builds ``csrc/embedding_grad.cu`` (with ``csrc/radix_sort.cuh`` and
``csrc/segment_sum.cuh``), prints ptxas's register and spill report of its
kernels, holds the radix sort equal to its plain version (a stable
``torch.sort`` of the clamped ids) and the gradient within the rounding
bound of ``chip_smoke.sum_tolerance`` at the DeepFM bench shape (131,072
ids over the [1,605,632, 32] table) and at K7's shape (ContraRec's
153,600 device-view ids over [1,007,616, 64]), with the same bits from
both orders (a full fill, then the levels; and the masked fill beside
them) and from the parent's prep (a stable sort of the raw ids).  Then it
times the whole path beside ``index_add_``, exactly as ``chip_smoke.py`` does, and replays
a CUDA graph of calls under torch.profiler for each kernel's time and one
call's timeline on the two streams.  Prints one JSON line.

    python3 scripts/torch_table_grad.py [--variants[=name,...] [--rounds=N]]

``--variants`` also times each part alone at both shapes (``parts``:
``chip_smoke.table_grad_parts`` and the design studies of
``design_parts``), and copies of the sources edited (VARIANTS: the fill's
blocks, threads, carve-out and stores; entries a thread of the sort; the
sort in three launches a pass; the levels' complete rows stored
evict-first, their fences, their registers; the levels without their row
writes, without their row loads or without the levels after the first,
wrong by design and read only for their times), timed through
``table_grad`` (``--rounds`` times, the kept build and the variants taking
turns), and once through ``sort_ids``, the levels and the masked fill
alone.  ``--variants=a,b`` builds only those.  Each variant's sort is held
equal to its plain version, and its gradient to the kept build's bits
unless it is wrong by design.  They build into ``chiprun_out/eg_variants/``.
"""
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rec_pangu_tpu_torch.ops.embedding import padded_rows  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import _build  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import embedding_grad as grad  # noqa: E402

SOURCE = _build.CSRC_DIR / "embedding_grad.cu"

# the three-launch sort's first two kernels (inserted into radix_sort.cuh)
THREE_LAUNCH_KERNELS = r"""
__global__ void __launch_bounds__(kThreads) upsweep_kernel(Pass a) {
  __shared__ uint32_t counts[kMaxRadix];
  const int t = threadIdx.x;
  const uint32_t mask = a.radix - 1;
  for (int i = t; i < a.radix; i += kThreads) counts[i] = 0;
  __syncthreads();
  const int64_t tile = blockIdx.x;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int64_t i = tile * kTile + r * kThreads + t;
    if (i < a.n) {
      const int32_t k = a.src_pos != nullptr ? __ldg(a.src_keys + i)
                                             : clamp_id(__ldg(a.src_keys + i), a.num_rows);
      atomicAdd(&counts[digit_of(k, a.shift, mask)], 1u);
    }
  }
  __syncthreads();
  for (int d = t; d < a.radix; d += kThreads) a.status[tile * a.radix + d] = counts[d];
}

__global__ void __launch_bounds__(1024) scan_kernel(Pass a, int64_t tiles) {
  __shared__ unsigned long long seg_sum[1024];
  const int d = threadIdx.x % a.radix, seg = threadIdx.x / a.radix, segs = 1024 / a.radix;
  const int64_t per = (tiles + segs - 1) / segs, lo = seg * per;
  const int64_t hi = lo + per < tiles ? lo + per : tiles;
  unsigned long long sum = 0;
  for (int64_t j = lo; j < hi; ++j) sum += a.status[j * a.radix + d];
  seg_sum[threadIdx.x] = sum;
  __syncthreads();
  unsigned long long before = 0;
  for (int s = 0; s < seg; ++s) before += seg_sum[s * a.radix + d];
  for (int64_t j = lo; j < hi; ++j) {
    const unsigned long long c = a.status[j * a.radix + d];
    a.status[j * a.radix + d] = before;
    before += c;
  }
}

"""
# variants whose results are wrong by design, read only for their times
WRONG_BY_DESIGN = ("levels_no_complete_writes", "levels_no_row_loads", "levels_level0_only")

# name -> (old, new) edits of csrc/embedding_grad.cu or a csrc/*.cuh, every
# occurrence of old in the file that holds it
VARIANTS = {
    "fill_2_blocks_an_sm": [("constexpr int kFillBlocksPerSm = 1;",
                             "constexpr int kFillBlocksPerSm = 2;")],
    "fill_256_threads": [("constexpr int kFillThreads = 128;",
                          "constexpr int kFillThreads = 256;")],
    "fill_64_threads": [("constexpr int kFillThreads = 128;",
                         "constexpr int kFillThreads = 64;")],
    "fill_default_carveout": [("cudaSharedmemCarveoutMaxShared", "cudaSharedmemCarveoutDefault")],
    "fill_plain_stores": [("if (!((m >> r) & 1u)) __stcs(dst + j, zero);",
                           "if (!((m >> r) & 1u)) dst[j] = zero;")],
    "sort_8_a_thread": [("constexpr int kPerThread = 4;", "constexpr int kPerThread = 8;")],
    # upsweep (each tile's digit counts), scan (each digit's count over the
    # earlier tiles), downsweep (the pass kernel reading that count instead
    # of looking back): three launches a pass, no tile waits on another
    "sort_three_launch": [
        ("    store_status(a.status + tile * a.radix + t, (tile == 0 ? kPrefix : kAggregate) | total);\n",
         ""),
        ("const uint32_t earlier = tile == 0 ? 0u : look_back(a.status, tile, t, a.radix);",
         "const uint32_t earlier = (uint32_t)load_status(a.status + tile * a.radix + t);"),
        ("    if (tile > 0) store_status(a.status + tile * a.radix + t, kPrefix | (earlier + total));\n",
         ""),
        ("// Zeroes the workspace's head and counts the digits", THREE_LAUNCH_KERNELS
         + "// Zeroes the workspace's head and counts the digits"),
        ("    pass_kernel<<<(unsigned)tiles, kThreads, 0, stream>>>(a);",
         "    upsweep_kernel<<<(unsigned)tiles, kThreads, 0, stream>>>(a);\n"
         "    scan_kernel<<<1, 1024, 0, stream>>>(a, tiles);\n"
         "    pass_kernel<<<(unsigned)tiles, kThreads, 0, stream>>>(a);")],
    "levels_streaming_writes": [("      dst[c] = sum[k];",
                                 "      if (complete) __stcs(dst + c, sum[k]); else dst[c] = sum[k];")],
    # the levels' fences acquire-release instead of sequentially consistent
    "levels_fence_acq_rel": [("    __threadfence();",
                              '    asm volatile("fence.acq_rel.gpu;" ::: "memory");')],
    # at most 64 registers at dim <= 32, so level 0's 4096 warps fit one wave
    "levels_4_blocks_an_sm": [("__global__ void __launch_bounds__(256)\n    segment_sum_kernel",
                               "__global__ void __launch_bounds__(256, kCols == 1 ? 4 : 1)\n"
                               "    segment_sum_kernel")],
    "levels_4_blocks_acq_rel": [
        ("    __threadfence();", '    asm volatile("fence.acq_rel.gpu;" ::: "memory");'),
        ("__global__ void __launch_bounds__(256)\n    segment_sum_kernel",
         "__global__ void __launch_bounds__(256, kCols == 1 ? 4 : 1)\n    segment_sum_kernel")],
    "levels_level0_only": [("    if (__shfl_sync(kFull, done, 0) != producers) return;",
                            "    return;")],
    "levels_no_complete_writes": [("if (id < 0 || id >= out.num_rows) return;", "return;")],
    "levels_no_row_loads": [("buf[g][k] = e < cnt && c < dim ? load(row + c, later) : 0.0f;",
                             "buf[g][k] = 0.0f * (float)(row - in.rows);")],
}


def ptxas_report() -> list:
    """ptxas's lines on the library's kernels (registers, spills, shared memory)."""
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    cmd = [_build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", os.devnull, str(SOURCE)]
    log = subprocess.run(cmd, capture_output=True, text=True, timeout=600).stderr
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def build_variants(chosen: list) -> dict:
    """(name -> the loaded library of each edited copy, name -> ptxas's
    lines on its level kernels), built in parallel."""
    import ctypes

    out = os.path.join(ROOT, "chiprun_out", "eg_variants")
    sources = [SOURCE, *sorted(_build.CSRC_DIR.glob("*.cuh"))]
    procs = {}
    for name in chosen:
        edits = VARIANTS[name]
        folder = os.path.join(out, name)
        shutil.rmtree(folder, ignore_errors=True)
        os.makedirs(folder)
        texts = {p.name: p.read_text() for p in sources}
        for old, new in edits:
            hits = [f for f, text in texts.items() if old in text]
            if not hits:
                raise RuntimeError(f"variant {name}: {old!r} not in the sources")
            for f in hits:
                texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            with open(os.path.join(folder, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(folder, "libembedding_grad.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", folder, "-o", lib,
               os.path.join(folder, SOURCE.name)]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), lib)
    libs, regs = {}, {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{err}")
        libs[name] = ctypes.CDLL(lib)
        lines = err.splitlines()
        regs[name] = [" ".join(x.strip() for x in lines[i + 1:i + 3])
                      for i, line in enumerate(lines)
                      if "Function properties for" in line and "segment_sum" in line]
    return libs, regs


def bound(lib) -> SimpleNamespace:
    """``grad._functions``' entry points, taken from another build."""
    kept = grad._functions(torch.device("cuda", torch.cuda.current_device()))
    fns = {}
    for key, fn in vars(kept).items():
        other = getattr(lib, fn.__name__)
        other.argtypes, other.restype = fn.argtypes, fn.restype
        fns[key] = other
    return SimpleNamespace(**fns)


def serialized(sorted_ids, perm, cot, rows: int, no_marks) -> torch.Tensor:
    """The order before the overlap, from the kept entry points: a full
    zero fill (the masked fill with no row marked), then the levels, one
    after the other on the current stream."""
    fns = grad._functions(cot.device)
    out = torch.empty(rows, cot.shape[1], device=cot.device)
    stream = torch.cuda.current_stream().cuda_stream
    grad._check_launch(fns.fill_unmarked(out.data_ptr(), rows, cot.shape[1], no_marks.data_ptr(),
                                         stream), "zero fill")
    grad._levels(sorted_ids, perm, cot, out, stream)
    return out


def design_parts(ids: list, cot, rows: int) -> dict:
    """The parts chip_smoke.py does not time, each alone (median_ms over the
    id sets): the sort's first launches with the row marks and the whole
    sort with them, a separate mark pass, a full fill; the masked fill on
    the second stream beside the sort and beside the levels (how far each
    pair overlaps) and forked after the sort instead of before its passes;
    the serialized order on presorted ids, and the whole paths: the
    parent's (torch.sort, then the serialized order), the radix sort before
    the serialized order, and ``table_grad``."""
    dev, dim = cot.device, cot.shape[1]
    fns = grad._functions(dev)

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def old_sort(x):
        sorted_ids, perm = torch.sort(x, stable=True)
        return sorted_ids, perm.to(torch.int32)

    head = (rows + 31) // 32  # the row marks

    def marked_sort(x):
        workspace = grad._sort_begin(x, rows, head, True, stream())
        return grad._sort_finish(x, rows, workspace, head, stream())

    sorted_sets = [grad.sort_ids(x, rows) for x in ids]
    no_marks = torch.zeros((rows + 31) // 32, dtype=torch.int32, device=dev)
    marks = [torch.empty_like(no_marks) for _ in ids]

    def mark(x, m):
        grad._check_launch(fns.mark_rows(x.data_ptr(), x.numel(), rows, m.data_ptr(), m.numel(),
                                         stream()), "row marks")

    for x, m in zip(ids, marks):
        mark(x, m)
    out = torch.empty(rows, dim, device=dev)

    def fill(m, on=None):
        grad._check_launch(fns.fill_unmarked(out.data_ptr(), rows, dim, m.data_ptr(),
                                             on.cuda_stream if on is not None else stream()),
                           "zero fill")

    def beside_fill(m, work):  # the fill on the second stream, work on this one
        main, side = torch.cuda.current_stream(dev), grad._side_stream(dev)
        side.wait_stream(main)
        fill(m, side)
        work()
        main.wait_stream(side)

    def fork_after_sort(x):  # the fill beside the levels only
        workspace = grad._sort_begin(x, rows, head, True, stream())
        s = grad._sort_finish(x, rows, workspace, head, stream())
        beside_fill(workspace, lambda: grad._levels(*s, cot, out, stream()))

    return {
        "sort_begin": cs.median_ms([lambda x=x: grad._sort_begin(x, rows, head, True, stream())
                                    for x in ids]),
        "sort_with_marks": cs.median_ms([lambda x=x: marked_sort(x) for x in ids]),
        "mark_pass": cs.median_ms([lambda x=x, m=m: mark(x, m) for x, m in zip(ids, marks)]),
        "full_fill": cs.median_ms([lambda: fill(no_marks)]),
        "fill_beside_sort": cs.median_ms([lambda x=x, m=m: beside_fill(
            m, lambda: grad.sort_ids(x, rows)) for x, m in zip(ids, marks)]),
        "fill_beside_levels": cs.median_ms([lambda s=s, m=m: beside_fill(
            m, lambda: grad._levels(*s, cot, out, stream())) for s, m in zip(sorted_sets, marks)]),
        "fork_after_sort": cs.median_ms([lambda x=x: fork_after_sort(x) for x in ids]),
        "serialized": cs.median_ms([lambda s=s: serialized(*s, cot, rows, no_marks)
                                    for s in sorted_sets]),
        "parent_path": cs.median_ms([lambda x=x: serialized(*old_sort(x), cot, rows, no_marks)
                                     for x in ids]),
        "radix_sort_serialized": cs.median_ms([lambda x=x: serialized(
            *grad.sort_ids(x, rows), cot, rows, no_marks) for x in ids]),
        "table_grad": cs.median_ms([lambda x=x: grad.table_grad(x, cot, rows) for x in ids]),
    }


def variant_times(libs: dict, regs: dict, shapes: dict, rounds: int) -> dict:
    """Each build's (the kept one's and each variant's) table_grad at each
    shape, ``rounds`` times, the builds taking turns in each round (the
    spread between rounds is the noise a single reading carries); in the
    first round also its sort_ids, levels and masked fill.  Its library is
    swapped in with its own second stream, after its sort is held equal to
    the plain version and its gradient, unless wrong by design, to the kept
    build's bits."""
    dev = torch.device("cuda", torch.cuda.current_device())
    kept = grad._functions(dev)
    sides = {"kept": dict(grad._SIDE)}
    builds = {"kept": kept, **{name: bound(lib) for name, lib in libs.items()}}
    stream = torch.cuda.current_stream().cuda_stream
    marks, want = {}, {}
    for shape, (ids, cot, rows) in shapes.items():
        marks[shape] = torch.empty((rows + 31) // 32, dtype=torch.int32, device="cuda")
        kept.mark_rows(ids[0].data_ptr(), ids[0].numel(), rows, marks[shape].data_ptr(),
                       marks[shape].numel(), stream)
        want[shape] = grad.table_grad(ids[0], cot, rows)
    out = {shape: torch.empty(rows, cot.shape[1], device="cuda")
           for shape, (ids, cot, rows) in shapes.items()}
    presorted = {shape: [grad.sort_ids(x, rows) for x in ids]
                 for shape, (ids, cot, rows) in shapes.items()}
    times = {"registers": regs, "rounds": rounds}
    try:
        for r in range(rounds):
            for name, fns in builds.items():
                grad._FN = fns
                grad._SIDE.clear()
                grad._SIDE.update(sides.get(name, {}))
                if name not in sides:
                    for shape, (ids, cot, rows) in shapes.items():
                        cs.check_sorts({f"{name} {shape}": (ids[0], rows)})
                        if name not in WRONG_BY_DESIGN:
                            cs.require_equal(grad.table_grad(ids[0], cot, rows), want[shape],
                                             f"variant {name} {shape}: the kept bits")
                    sides[name] = dict(grad._SIDE)
                entry = times.setdefault(name, {})
                for shape, (ids, cot, rows) in shapes.items():
                    row = entry.setdefault(shape, {"table_grad": []})
                    row["table_grad"].append(cs.median_ms(
                        [lambda x=x: grad.table_grad(x, cot, rows) for x in ids]))
                    if r:
                        continue
                    row["sort"] = cs.median_ms([lambda x=x: grad.sort_ids(x, rows) for x in ids])
                    row["levels"] = cs.median_ms([lambda s=s: grad._levels(
                        *s, cot, out[shape], torch.cuda.current_stream().cuda_stream)
                        for s in presorted[shape]])
                    row["masked_fill"] = cs.median_ms([lambda: fns.fill_unmarked(
                        out[shape].data_ptr(), rows, cot.shape[1], marks[shape].data_ptr(),
                        torch.cuda.current_stream().cuda_stream)])
    finally:
        grad._FN = kept
        grad._SIDE.clear()
        grad._SIDE.update(sides["kept"])
    return times


def check_shape(ids: list, cot, rows: int, what: str) -> dict:
    """The sort equal to its plain version; the gradient within its rounding
    bound of the plain version, and the same bits twice, from presorted ids
    (``launch``), from the serialized order and from the parent's prep."""
    cs.check_sorts({f"{what} {i}": (x, rows) for i, x in enumerate(ids)})
    x = ids[0]
    got = grad.table_grad(x, cot, rows)
    cs.require_equal(grad.table_grad(x, cot, rows), got, f"{what}: run twice")
    s = grad.sort_ids(x, rows)
    cs.require_equal(grad.launch(*s, cot, rows), got, f"{what}: presorted")
    no_marks = torch.zeros((rows + 31) // 32, dtype=torch.int32, device=cot.device)
    cs.require_equal(serialized(*s, cot, rows, no_marks), got, f"{what}: serialized order")
    raw, perm = torch.sort(x, stable=True)
    cs.require_equal(grad.launch(raw, perm.to(torch.int32), cot, rows), got,
                     f"{what}: the parent's prep")
    err = cs.require_within(got, grad.table_grad_reference(x, cot, rows),
                            cs.sum_tolerance(x, cot, rows)[0], what)
    return {"max_abs_err": err, "ids": x.numel(), "rows": rows, "dim": cot.shape[1]}


def graph_timeline(ids: list, cot, rows: int, shape: str) -> dict:
    """One replay of a CUDA graph of len(ids) table_grad calls under
    torch.profiler: each kernel's device ms a call, and the middle call's
    kernels, each with its start and duration (us, from the call's first
    kernel) and its stream, in start order.  The trace goes to
    ``chiprun_out/table_grad_graph_{shape}.json``."""
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in ids:
            grad.table_grad(x, cot, rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in ids:
            grad.table_grad(x, cot, rows)
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    path = os.path.join(ROOT, "chiprun_out", f"table_grad_graph_{shape}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memset") and "dur" in e]
    events.sort(key=lambda e: e["ts"])

    def name(e):
        return e["name"].split("(")[0].replace("void ", "").split("::")[-1][:40] or "fill"

    per_kernel = {}
    for e in events:
        per_kernel[name(e)] = per_kernel.get(name(e), 0.0) + e["dur"] / 1e3 / len(ids)
    # a call's first event: the sort's memset, just before its counting launch
    starts = [i - 1 for i, e in enumerate(events) if "histogram" in e["name"]]
    mid = len(starts) // 2
    call = events[starts[mid]:starts[mid + 1] if mid + 1 < len(starts) else len(events)]
    t0 = call[0]["ts"]
    return {"ms_a_call": per_kernel,
            "call": [(round(e["ts"] - t0, 2), round(e["dur"], 2), e.get("tid"), name(e))
                     for e in call]}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_table_grad: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    args = dict(a.lstrip("-").partition("=")[::2] for a in sys.argv[1:])
    want_variants = "variants" in args
    chosen = args["variants"].split(",") if args.get("variants") else list(VARIANTS)
    libs = build_variants(chosen) if want_variants else None
    report = ptxas_report()
    _build.build_all(["embedding_grad"])
    bandwidth = cs.peak_bandwidth(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 10)
    rows, id_sets, cot = cs.bench_table_inputs(gen)
    k7_rows = padded_rows(cs.SEQ_VOCAB)
    k7_ids = [cs.device_view_ids(gen, cs.SEED + 101 + i) for i in range(cs.SORTED_ID_SETS)]
    k7_cot = torch.randn(k7_ids[0].numel(), cs.SEQ_DIM, generator=gen, device="cuda") * 1e-3
    shapes = {"bench": (id_sets, cot, rows), "k7": (k7_ids, k7_cot, k7_rows)}
    out = {"nvidia_smi": smi, "ptxas": report, "plans": {}, "checks": {}, "ms": {},
           "kernels": {}}
    cs.check_sorts(cs.pass_sort_cases(gen))
    for shape, (ids, c, r) in shapes.items():
        out["plans"][shape] = grad.sort_plan(r)
        out["checks"][shape] = check_shape(ids, c, r, shape)
        n, dim = ids[0].numel(), c.shape[1]
        moved = r * dim * 4 + n * dim * 4 + n * 4
        lib = torch.zeros(r, dim, device="cuda")
        longs = [x.long() for x in ids]
        out["ms"][shape] = {
            "table_grad": cs.median_ms([lambda x=x: grad.table_grad(x, c, r) for x in ids]),
            "library": cs.median_ms([lambda x=x: lib.zero_().index_add_(0, x, c) for x in longs]),
            "bound": moved / bandwidth * 1e3}
        if want_variants:
            out["ms"][shape]["parts"] = {**cs.table_grad_parts(ids, c, r),
                                         **design_parts(ids, c, r)}
        out["kernels"][shape] = graph_timeline(ids, c, r, shape)
    if libs:
        out["variants"] = variant_times(*libs, shapes, int(args.get("rounds") or 1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
