"""K3, the fused table Adam, alone on one CUDA card, beside its parent's.

    python3 scripts/torch_fused_adam.py [--parent TREE] [--variants[=a,b]]

Builds this tree's ``csrc/fused_adam.cu`` (and TREE's, and with
``--variants`` edited copies of this one: VARIANTS) with ptxas's report of
their kernels.  At each width the port trains -- D = 1 (the LR tables'
``[1,605,632, 1]``), D = 32 (DeepFM's), D = 40 (the multi-task zoo's), each
with a batch's 131,072 fused ids, and SASRec's ``[1,007,616, 64]`` with
51,200 history ids and the dense stream, f32 and bfloat16 moments -- it
holds this tree's K3 within ``chip_smoke.check_adam_step``'s rounding
bounds of the plain version, and every other build bit for bit against
this tree's.  Then it times each build in turns (parent, this, this,
parent; the variants once), the update with its radix sort and the kernel
alone on presorted ids, as ``chip_smoke.median_ms`` does, and replays a
CUDA graph of calls under torch.profiler for each launch's device time a
call.  Prints one JSON line, with the card's name and power limit; exit 1
if a check fails.  Builds go to ``rec_pangu_tpu_torch/_build/k3_variants/``.
"""
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rec_pangu_tpu_torch.ops.embedding import padded_rows  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import _build  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import embedding_grad as grad  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import embedding_lookup as lookup  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import fused_adam as adam  # noqa: E402
from torch_variants import build, edited, nvidia_smi  # noqa: E402

OUT = str(_build.BUILD_DIR / "k3_variants")
SOURCE = "rec_pangu_tpu_torch/csrc/fused_adam.cu"

HEADER = "rec_pangu_tpu_torch/csrc/segment_sum.cuh"

# loads and stores of the Adam stream marked evict-first (__ldcs, __stcs)
STREAMING = r"""
template <typename T, typename W>
__device__ __forceinline__ T ldcs_as(const T* p) {
  T x;
  *reinterpret_cast<W*>(&x) = __ldcs(reinterpret_cast<const W*>(p));
  return x;
}
template <typename T>
__device__ __forceinline__ T ldcs(const T* p) {
  if constexpr (sizeof(T) == 16) return ldcs_as<T, float4>(p);
  else if constexpr (sizeof(T) == 8) return ldcs_as<T, float2>(p);
  else if constexpr (sizeof(T) == 4) return ldcs_as<T, float>(p);
  else return ldcs_as<T, unsigned short>(p);
}
template <typename T, typename W>
__device__ __forceinline__ void stcs_as(T* p, const T& x) {
  __stcs(reinterpret_cast<W*>(p), *reinterpret_cast<const W*>(&x));
}
template <typename T>
__device__ __forceinline__ void stcs(T* p, const T& x) {
  if constexpr (sizeof(T) == 16) stcs_as<T, float4>(p, x);
  else if constexpr (sizeof(T) == 8) stcs_as<T, float2>(p, x);
  else if constexpr (sizeof(T) == 4) stcs_as<T, float>(p, x);
  else stcs_as<T, unsigned short>(p, x);
}

constexpr int kThreads = 256;"""
STREAM_HELPERS = ("\nconstexpr int kThreads = 256;", STREAMING)
STREAM_LOADS = [("    V pv = pg[q], gv = gg[q];\n    MP mv = mg[q], vv = vg[q];",
                 "    V pv = ldcs(pg + q), gv = gg[q];\n"
                 "    MP mv = ldcs(mg + q), vv = ldcs(vg + q);"),
                ("      const V dv = dg[q];", "      const V dv = ldcs(dg + q);")]
STREAM_STORES = [("    pg[q] = pv;\n    mg[q] = mv;\n    vg[q] = vv;",
                  "    stcs(pg + q, pv);\n    stcs(mg + q, mv);\n    stcs(vg + q, vv);")]
# segment_sum.cuh's choice of lanes over columns or over entries
LANES = "return dim < 32 ? 0 : dim == 32 ? 1 : dim <= 64 ? 2 : 4;"

# name -> edits of this tree's source ("cu") and of segment_sum.cuh ("cuh"),
# fused_adam's plan constants it replaces ("plan"), and "wrong" for a
# variant whose results are wrong by design (read only for its time)
VARIANTS = {
    "tile8192_align4": {"plan": {"TILE_FLOATS": 8192, "TILE_ALIGN": 4}},
    "align4": {"plan": {"TILE_ALIGN": 4}},
    "stream": {"cu": [STREAM_HELPERS] + STREAM_LOADS + STREAM_STORES},
    "levels_by_columns": {"cuh": [(LANES, "return dim <= 32 ? 1 : dim <= 64 ? 2 : 4;")]},
    "levels_by_entries_at_32": {"cuh": [(LANES, "return dim <= 32 ? 0 : dim <= 64 ? 2 : 4;")]},
    "level0_only": {"cuh": [("    if (last_level) return;\n    // publish",
                             "    return;\n    // publish")], "wrong": True},
}


def caller(lib, tile_of):
    """An update through ``lib``'s entry point on ``sort_for``'s output,
    with the tile rows ``tile_of(num_rows, dim)``, as ``fused_adam.launch``
    calls its own."""
    fn, words = lib.rp_fused_adam_f32, lib.rp_fused_adam_workspace_words
    ours, our_words = adam._kernel()
    fn.argtypes, fn.restype = ours.argtypes, ours.restype
    words.argtypes, words.restype = our_words.argtypes, our_words.restype

    def call(plan, rows, p, m, v, hyper, dense=None):
        dim, num_rows, n = rows.shape[1], p.shape[0], plan.sorted_ids.numel()
        tile = tile_of(num_rows, dim)
        scratch = torch.empty(words(n, num_rows, dim, tile), dtype=torch.float32, device="cuda")
        err = fn(plan.sorted_ids.data_ptr(), plan.perm.data_ptr(), rows.data_ptr(), n,
                 scratch.data_ptr(), scratch.numel(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
                 num_rows, dim, tile, *adam._hyper_values(hyper),
                 None if dense is None else dense.data_ptr(), int(m.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_adam launch failed: CUDA error {err}")
    return call


def plan_rows(**constants):
    """tile_of for ``caller``: the plan's tile rows with some of
    fused_adam's plan constants (TILE_FLOATS, TILES_PER_SM, TILE_ALIGN)
    replaced."""
    def tile_of(num_rows, dim):
        kept = {k: getattr(adam, k) for k in constants}
        for k, x in constants.items():
            setattr(adam, k, x)
        try:
            return adam.tile_plan(num_rows, dim, cs.sms()).tile_rows
        finally:
            for k, x in kept.items():
                setattr(adam, k, x)
    return tile_of


def shapes(gen) -> dict:
    """name -> (id sets, table rows, width, with the dense stream, moment dtype)."""
    bench_rows = padded_rows(cs.FIELDS * (cs.VOCAB + 1))
    offsets = torch.arange(cs.FIELDS, device="cuda", dtype=torch.int32) * (cs.VOCAB + 1)
    bench_ids = [lookup.fused_ids(torch.randint(0, cs.VOCAB + 1, (cs.BATCH, cs.FIELDS),
                                                generator=gen, device="cuda",
                                                dtype=torch.int32), offsets)
                 for _ in range(cs.ID_SETS)]
    seq_rows, n = padded_rows(cs.SEQ_VOCAB), cs.SEQ_BATCH * cs.SEQ_L
    hist = [torch.randint(0, cs.SEQ_VOCAB, (n,), generator=gen, device="cuda", dtype=torch.int32)
            for _ in range(cs.ID_SETS)]
    out = {}
    for dim in (1, 32, 40):
        out[f"d{dim}"] = (bench_ids, bench_rows, dim, None, torch.float32)
    for key, dtype in (("seq_f32", torch.float32), ("seq_bf16", torch.bfloat16)):
        out[key] = (hist, seq_rows, cs.SEQ_DIM, True, dtype)
    return out


def graph_parts(update, plans, args) -> dict:
    """Each launch's device ms a call, from one replay of a CUDA graph of
    len(plans) calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for s in plans:
            update(s, *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for s in plans:
            update(s, *args)
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    path = os.path.join(OUT, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memset") and "dur" in e]
    os.remove(path)
    parts = {}
    for e in events:
        name = e["name"].replace("(anonymous namespace)::", "").replace("void ", "")
        name = name.split("(")[0].split("::")[-1][:48] or "memset"
        parts[name] = parts.get(name, 0.0) + e["dur"] / 1e3 / len(plans)
    return parts


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_fused_adam: CUDA is not available", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    this_src = open(os.path.join(ROOT, SOURCE)).read()
    this_header = open(os.path.join(ROOT, HEADER)).read()
    sources = {"this": (this_src, None)}
    parent = argv[argv.index("--parent") + 1] if "--parent" in argv else None
    if parent:  # the parent's source on the parent's header
        sources["parent"] = tuple(open(os.path.join(parent, f)).read() for f in (SOURCE, HEADER))
    chosen = next((a.partition("=")[2] for a in argv if a.startswith("--variants")), None)
    names = [] if chosen is None else chosen.split(",") if chosen else list(VARIANTS)
    for k in names:
        spec = VARIANTS[k]
        sources[k] = (edited(this_src, spec.get("cu", [])),
                      edited(this_header, spec["cuh"]) if "cuh" in spec else None)
    _build.build_all(["embedding_grad", "fused_adam"])
    libs, report = build(sources, OUT, "fused_adam.cu", "segment_sum.cuh")
    calls = {"this": caller(libs["this"], plan_rows())}
    if parent:
        calls["parent"] = caller(libs["parent"], lambda num_rows, dim: max(1, 8192 // dim))
    for k in names:
        spec = VARIANTS[k]
        calls[k] = caller(libs[k], plan_rows(**spec.get("plan", {})))
    order = ["parent", "this", "this", "parent"] if parent else ["this"]
    order += names

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 150)
    hyper = adam.adam_hyper(4, cs.LR)
    result = {"nvidia_smi": smi, "ptxas": report, "shapes": {}, "failed": []}
    for shape, (ids, num_rows, dim, with_dense, dtype) in shapes(gen).items():
        cot = torch.randn(ids[0].numel(), dim, generator=gen, device="cuda") * 1e-3
        dense = (torch.randn(num_rows, dim, generator=gen, device="cuda") * 1e-6
                 if with_dense else None)
        p, m, v = cs.adam_state(num_rows, dim, gen)
        m, v = m.to(dtype), v.to(dtype)
        row = {"table": [num_rows, dim], "ids": ids[0].numel(), "moments": str(dtype),
               "dense": with_dense, "tile_plan": adam.tile_plan(num_rows, dim, cs.sms())._asdict()}
        try:  # this tree's wrapper against the plain version
            row["max_abs_err"] = cs.check_adam_step(ids[0], cot, (p, m, v), hyper, shape, dense)
        except RuntimeError as e:
            row["check"] = f"failed: {e}"
            result["failed"].append(f"{shape}/plain")
        plans = [adam.sort_for(x, num_rows) for x in ids]
        outs = {}
        for name, call in calls.items():  # every build from the same state, one update
            state = [t.clone() for t in (p, m, v)]
            call(plans[0], cot, *state, hyper, dense)
            outs[name] = state
        torch.cuda.synchronize()
        row["bit_equal"] = {name: all(torch.equal(a, b) for a, b in zip(outs[name], outs["this"]))
                            for name in outs if name != "this"}
        result["failed"] += [f"{shape}/{k}" for k, ok in row["bit_equal"].items()
                             if not ok and not VARIANTS.get(k, {}).get("wrong")]
        del outs
        times = {}
        for i, name in enumerate(order):
            call = calls[name]
            times[f"{name}_{i}"] = {
                "ms": cs.median_ms([lambda x=x: call(adam.sort_for(x, num_rows), cot, p, m, v,
                                                     hyper, dense) for x in ids]),
                "kernel_only_ms": cs.median_ms([lambda s=s: call(s, cot, p, m, v, hyper, dense)
                                                for s in plans])}
        row["times"] = times
        row["sort_ms"] = cs.median_ms([lambda x=x: grad.sort_ids(x, num_rows) for x in ids])
        row["parts"] = {name: graph_parts(calls[name], plans, (cot, p, m, v, hyper, dense))
                        for name in ("parent", "this") if name in calls}
        result["shapes"][shape] = row
        del p, m, v, dense, plans
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
