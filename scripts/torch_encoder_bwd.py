"""K4b, the transformer-encoder backward, alone on one CUDA card.

    python3 scripts/torch_encoder_bwd.py [--variants] [--parent TREE]

At SASRec's bench shape (1024 histories of 50 x 64, 2 layers of 4 heads,
inner 32, gelu, dropout 0.1) and IOCRec's (3072 views, 3 layers of 2
heads, inner 128, relu, eps 1e-12, dropout 0.5): prints ptxas's register
and spill report of ``csrc/fused_encoder.cu``, holds the training forward's
saved activations and each launch of the backward against its plain
version (``chip_smoke.check_encoder_bwd_stages``), and times the backward
whole and launch by launch (the weight transposes, layer 0's row launch R,
attention launch A and weight-gradient launch W, the ordered sum), the
training forward with and without its stores, and one call's timeline of
launches under torch.profiler (``chiprun_out/k4b_graph_*.json``).  Prints
one JSON line.

``--variants`` also times each launch from edited copies of the source
(VARIANTS: parts left out, other launch bounds, p by division).
``--parent TREE`` times an older tree's one-launch backward (each sample's
layers recomputed and differentiated in one block, from
``TREE/rec_pangu_tpu_torch/csrc/fused_encoder.cu``), with ``--variants``
also edited copies of it that leave parts out (PARENT_VARIANTS: the
recompute, the FFN and LayerNorm part, the attention part, the weight
gradients, the final ordered sum).  The variants' results are wrong by
design; only their times are read.  They build into
``chiprun_out/k4b_variants/``.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import _build  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import fused_encoder as encoder  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "k4b_variants")

# name -> (old, new) edits of the older tree's fused_encoder.cu, every
# occurrence of old; "if (false) " before a call leaves it out
_SKIP = "if (false) "
PARENT_VARIANTS = {
    "no_recompute": [(f"      {c}", f"      {_SKIP}{c}") for c in (
        "gemm<NT, gStore>(X, ld, 0, 1, D, wqkvo,", "attention_train<NT>(Q, Kb, V, C,",
        "gemm<NT, gDropResidual>(C, ld,", "ln_rows<NT>(XC1,", "gemm<NT, gStoreBoth>(X1,",
        "gemm<NT, gDropResidual>(HR,", "ln_rows<NT>(XC2,")],
    "no_ffn_ln": [(f"      {c}", f"      {_SKIP}{c}") for c in (
        "ln_param_grads<NT>(dys,", "ln_bwd_rows<NT>(dys,", "wgrad<NT>(HR,",
        "colsum<NT>(dys, ld, 0, D, D, L, g_b2", "gemm<NT, gActGrad>(dys,", "wgrad<NT>(X1,",
        "colsum<NT>(HR,", "gemm<NT, gAccumulate>(HR,", "ln_param_grads<NT>(dxs,",
        "ln_bwd_rows<NT>(dxs,")],
    "no_attention": [("        attention_bwd_head<NT>(",
                      f"        {_SKIP}attention_bwd_head<NT>(")],
    "no_weight_grads": [(f"      {c}", f"      {_SKIP}{c}") for c in (
        "wgrad<NT>(HR,", "colsum<NT>(dys, ld, 0, D, D, L, g_b2", "wgrad<NT>(X1,",
        "colsum<NT>(HR,", "wgrad<NT>(C,", "colsum<NT>(dys, ld, 0, D, D, L, g_bqkvo",
        "wgrad<NT>(X, ld,", "colsum<NT>(C,", "ln_param_grads<NT>(dys,",
        "ln_param_grads<NT>(dxs,")],
    "no_sum_slices": [("  return (int)rp::sum_slices(B.partials, blocks, count, "
                       "static_cast<float*>(grads), st);", "  return 0;")],
}

# name -> (old, new) edits of this tree's fused_encoder.cu: parts of the
# backward's launches left out, or other shapes of them
VARIANTS = {
    "a_no_score_tiles": [("for (int item = threadIdx.x; item < 2 * lt * lt; item += kBwdThreads) {",
                          "for (int item = threadIdx.x; item < 0; item += kBwdThreads) {")],
    "a_no_row_pass": [("for (int l0 = 4 * warp; l0 < L; l0 += kBwdThreads / 8) {",
                       "for (int l0 = 4 * warp; l0 < 0; l0 += kBwdThreads / 8) {")],
    "a_exact_p": [("      const float rtotal = 1.0f / group_sum(e);",
                   "      const float total = group_sum(e);"),
                  ("        pr[t] = e[t] * rtotal;", "        pr[t] = e[t] / total;")],
    "a_no_tiles": [("for (int item = threadIdx.x; item < 3 * per; item += kBwdThreads) {",
                    "for (int item = threadIdx.x; item < 0; item += kBwdThreads) {")],
    "a_no_projection": [("  tile_gemm(IN, lay.ldin, L, 3 * D,",
                         f"  {_SKIP}tile_gemm(IN, lay.ldin, L, 3 * D,")],
    "a_bounds_3": [("__launch_bounds__(kBwdThreads) encoder_attention_kernel",
                    "__launch_bounds__(kBwdThreads, 3) encoder_attention_kernel")],
    "r_no_layernorm": [("  ln_bwd_tile(P, F, U, inv,", f"  {_SKIP}ln_bwd_tile(P, F, U, inv,")],
    "r_no_products": [(f"  tile_gemm({c}", f"  {_SKIP}tile_gemm({c}") for c in (
        "F, ld, rows, D, p.wt.w2,", "U, ldh, rows, inner,", "F, ld, rows, D, p.wt.wo,")],
    "r_bounds_3": [("__launch_bounds__(kBwdThreads) encoder_rows_kernel",
                    "__launch_bounds__(kBwdThreads, 3) encoder_rows_kernel")],
    "w_no_products": [("    for (int k = 0; k < kn; ++k) {\n      const float4 a = "
                       "*reinterpret_cast<const float4*>(As",
                       "    for (int k = 0; k < 0; ++k) {\n      const float4 a = "
                       "*reinterpret_cast<const float4*>(As")],
}


def edited(text: str, variants: dict) -> dict:
    """name -> the source with the variant's edits (each must match)."""
    out = {}
    for name, edits in variants.items():
        t = text
        for old, new in edits:
            if old not in t:
                raise RuntimeError(f"variant {name}: {old!r} not in the source")
            t = t.replace(old, new)
        out[name] = t
    return out


def variant_times(cases: dict) -> dict:
    """Each launch alone (chip_smoke.encoder_bwd_parts) with each variant's
    library bound in place of the kept one, at each shape."""
    from rec_pangu_tpu_torch.ops.kernels import encoder_bwd as ebwd

    libs = build_sources(edited((_build.CSRC_DIR / "fused_encoder.cu").read_text(), VARIANTS))
    kept = ebwd._functions()
    out = {}
    try:
        for shape, (x, kv, packed, opts) in cases.items():
            launches = 5 if shape == "iocrec" else cs.BWD_LAUNCHES
            _, saved = encoder.launch_train(x, kv, packed, *opts, save=True)
            dy = torch.randn_like(x)
            out[shape] = {}
            for name, lib in libs.items():
                ebwd._FNS = ebwd.bind(lib)
                out[shape][name] = cs.encoder_bwd_parts(saved, kv, dy, packed, opts, launches)
            ebwd._FNS = kept
            out[shape]["kept"] = cs.encoder_bwd_parts(saved, kv, dy, packed, opts, launches)
            del saved
    finally:
        ebwd._FNS = kept
    return out


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def ptxas_report(source) -> list:
    """ptxas's lines on the source's kernels (registers, spills, shared memory)."""
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    cmd = [_build._nvcc(), *flags, "-Xptxas", "-v", "-I", str(_build.CSRC_DIR), "-c", "-o",
           os.devnull, str(source)]
    log = subprocess.run(cmd, capture_output=True, text=True, timeout=600).stderr
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def build_sources(sources: dict, out_dir: str = OUT) -> dict:
    """name -> the loaded library of each source text, built in parallel
    into ``out_dir`` (the shared headers from this tree's csrc/)."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{err}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def shapes(dev, gen) -> dict:
    """name -> (x, key_valid, packed, options) at SASRec's and IOCRec's shapes."""
    def x_of(n):
        return torch.randn(n, cs.SEQ_L, cs.SEQ_DIM, generator=gen, device=dev) * (
            2.0 / cs.SEQ_DIM) ** 0.5

    sas = cs.random_encoder(cs.SEQ_DIM, 4, 32, 2, "gelu", cs.SEED + 44, dev)
    ioc = cs.random_encoder(cs.SEQ_DIM, 2, 128, 3, "relu", cs.SEED + 47, dev, 1e-12)
    return {
        "sasrec": (x_of(cs.SEQ_BATCH), cs.prefix_masks(cs.SEQ_BATCH, cs.SEQ_L, gen),
                   [t.detach() for t in sas.packed()],
                   (4, True, "gelu", sas.layer_norm_eps, cs.DROP, cs.DROP, 7)),
        "iocrec": (x_of(cs.IOC_VIEWS), torch.ones(cs.IOC_VIEWS, cs.SEQ_L, device=dev),
                   [t.detach() for t in ioc.packed()],
                   (2, True, "relu", 1e-12, cs.IOC_DROP, cs.IOC_DROP, 7)),
    }


def parent_times(tree: str, variants: bool, cases: dict) -> dict:
    """The older tree's one-launch backward (and its edited copies) at each
    shape, through this tree's forward for the saved layer inputs."""
    source = os.path.join(tree, "rec_pangu_tpu_torch", "csrc", "fused_encoder.cu")
    text = open(source).read()
    sources = {"parent": text, **(edited(text, PARENT_VARIANTS) if variants else {})}
    libs = build_sources(sources)
    out = {"ptxas": ptxas_report(source)}
    for shape, (x, kv, packed, opts) in cases.items():
        heads, causal, act, eps, hidden, attn, seed = opts
        N, L, D = x.shape
        layers, inner = packed[0].shape[0], packed[2].shape[-1]
        # the older layout: each layer's input, [layers, N, L, D]
        saved = torch.empty(layers, N, L, D, device=x.device)
        h = x
        with torch.no_grad():
            for li in range(layers):
                saved[li] = h
                one = [t[li:li + 1].contiguous() for t in packed]
                h = encoder.fused_encoder(h, kv, one, heads, causal, act, eps, True, hidden,
                                          attn, seed)
        dy = torch.randn_like(x)
        dx = torch.empty_like(x)
        grads = torch.empty(sum(t.numel() for t in packed), device=x.device)
        kvf = kv.float().contiguous()
        times = {}
        for name, lib in libs.items():
            fn, words = lib.rp_fused_encoder_bwd_f32, lib.rp_fused_encoder_bwd_workspace_words
            fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_longlong, ctypes.c_longlong]
                           + [ctypes.c_int] * 7 + [ctypes.c_float] + encoder._DROP_ARGS
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            words.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 4
            words.restype = ctypes.c_longlong
            work = torch.empty(words(N, L, D, layers, inner), device=x.device)
            args = (saved.data_ptr(), kvf.data_ptr(), dy.data_ptr(),
                    *(t.data_ptr() for t in packed), dx.data_ptr(), grads.data_ptr(),
                    work.data_ptr(), work.numel(), N, L, D, layers, heads, inner,
                    int(causal), encoder.ACTIVATIONS[act], float(eps),
                    *encoder._dropout_args(seed, hidden, attn))

            def call(fn=fn, args=args):
                err = fn(*args, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            reps = 5 if shape == "iocrec" else cs.TIMING_REPS
            times[name] = cs.median_ms([call], 5 if shape == "iocrec" else cs.BWD_LAUNCHES, reps)
        out[shape] = times
    return out


def graph_timeline(call, calls: int, shape: str) -> dict:
    """One replay of a CUDA graph of ``calls`` K4b calls under
    torch.profiler: each kernel's device ms a call, and the middle call's
    launches, each with its start and duration (us, from the call's first
    launch), in start order.  The trace goes to
    ``chiprun_out/k4b_graph_{shape}.json``."""
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            call()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    path = os.path.join(ROOT, "chiprun_out", f"k4b_graph_{shape}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy") and "dur" in e]
    events.sort(key=lambda e: e["ts"])

    def name(e):
        n = e["name"].replace("(anonymous namespace)::", "").replace("void ", "")
        return n.split("(")[0].split("::")[-1][:40] or "memset"

    per_kernel = {}
    for e in events:
        per_kernel[name(e)] = per_kernel.get(name(e), 0.0) + e["dur"] / 1e3 / calls
    starts = [i for i, e in enumerate(events) if "transpose_weights" in e["name"]]
    mid = len(starts) // 2
    one = events[starts[mid]:starts[mid + 1] if mid + 1 < len(starts) else len(events)]
    t0 = one[0]["ts"]
    return {"ms_a_call": per_kernel,
            "call": [(round(e["ts"] - t0, 2), round(e["dur"], 2), name(e)) for e in one]}


def new_times(cases: dict) -> dict:
    """This tree's K4b at each shape: each launch against its plain version
    (chip_smoke.check_encoder_bwd_stages), the whole backward, the training
    forward with and without its stores, each launch alone and one call's
    timeline."""
    out = {}
    for shape, (x, kv, packed, opts) in cases.items():
        ioc = shape == "iocrec"
        launches, reps = (5, 5) if ioc else (cs.BWD_LAUNCHES, cs.TIMING_REPS)
        stages = cs.check_encoder_bwd_stages(x, kv, packed, opts, shape)
        _, saved = encoder.launch_train(x, kv, packed, *opts, save=True)
        dy = torch.randn_like(x)

        def backward():
            encoder.launch_backward(saved, kv, dy, packed, *opts)

        t = {"max_rel_err": stages["max_rel_err"],
             "k4b": cs.median_ms([backward], launches, reps),
             "forward_save": cs.median_ms([lambda: encoder.launch_train(
                 x, kv, packed, *opts, save=True)], launches, reps),
             "forward_no_save": cs.median_ms([lambda: encoder.launch_train(
                 x, kv, packed, *opts, save=False)], launches, reps),
             "saved_bytes": saved.numel() * 4,
             "parts_layer0": cs.encoder_bwd_parts(saved, kv, dy, packed, opts, launches),
             "timeline": graph_timeline(backward, 3, shape)}
        out[shape] = t
        del saved
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_encoder_bwd: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 110)
    cases = shapes(dev, gen)
    result = {"nvidia_smi": nvidia_smi(),
              "ptxas": ptxas_report(_build.CSRC_DIR / "fused_encoder.cu")}
    result["new"] = new_times(cases)
    if "--variants" in argv:
        result["variants"] = variant_times(cases)
    if "--parent" in argv:
        tree = argv[argv.index("--parent") + 1]
        result["parent"] = parent_times(tree, "--variants" in argv, cases)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
