"""K4f, the transformer-encoder forward, alone on one CUDA card.

    python3 scripts/torch_encoder_fwd.py [--variants] [--parent TREE [--parent-variants]]

At SASRec's bench shape (1024 histories of 50 x 64, 2 layers of 4 heads,
inner 32, gelu, prefix masks; serving, and training with dropout 0.1) and
IOCRec's (3072 views, 3 layers of 2 heads, inner 128, relu, eps 1e-12,
every key valid; serving, and training with dropout 0.5): prints ptxas's
register and spill report of ``csrc/fused_encoder.cu`` (and of each
variant),
holds the serving forward against the plain version
(``chip_smoke.check_encoder``) and the training forward's y and saved
activations against ``encoder_bwd.train_forward_reference``
(``chip_smoke.check_encoder_saved``), and times K4f in serving mode, in
training mode with its stores and without them.  Prints one JSON line.

``--variants`` also times edited copies of this tree's source (VARIANTS:
parts left out, the training stores by kind or kept in L2, p by a
product, other rings, chunks and unrollings, the products in split TF32
on the tensor cores); the split-TF32 copy is also held to the gates
(``variant_gates``).  ``--parent-variants`` times edited copies of the
older tree's source (PARENT_VARIANTS).  A variant's results are wrong by
design; only its times are read.  The copies build into
``build/k4f_variants/``.

``--parent TREE`` builds TREE's ``rec_pangu_tpu_torch/csrc/fused_encoder.cu``
(the same C entry points), compares its outputs with this tree's bit for
bit on the same inputs (serving y; training y and every saved activation)
and times both in turns: parent, this tree, this tree, parent.
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

OUT = os.path.join(ROOT, "build", "k4f_variants")
_SKIP = "if (false) "

# name -> (old, new) edits of the older tree's fused_encoder.cu (one
# sample a block, weights read from L2 in the k loop), every occurrence of
# old; "if (false) " before a call leaves it out
PARENT_VARIANTS = {
    "no_qkv": [("    project(xs, ld, D, wqkvo, bqkvo, 3,",
                f"    {_SKIP}project(xs, ld, D, wqkvo, bqkvo, 3,"),
               ("    gemm<kThreads, gStore>(xs,", f"    {_SKIP}gemm<kThreads, gStore>(xs,")],
    "no_attention": [("    attention(qs,", f"    {_SKIP}attention(qs,"),
                     ("    attention_train<kThreads>(qs,",
                      f"    {_SKIP}attention_train<kThreads>(qs,")],
    "no_wo_ffn": [("    project(cs,", f"    {_SKIP}project(cs,"),
                  ("    project(xs, ld, D, P.w1", f"    {_SKIP}project(xs, ld, D, P.w1"),
                  ("    project(hs,", f"    {_SKIP}project(hs,"),
                  ("    gemm<kThreads, gDropResidual>(",
                   f"    {_SKIP}gemm<kThreads, gDropResidual>("),
                  ("    gemm<kThreads, gStoreBoth>(", f"    {_SKIP}gemm<kThreads, gStoreBoth>(")],
    "no_layernorm": [("    layer_norm(xs,", f"    {_SKIP}layer_norm(xs,"),
                     ("    ln_rows<kThreads>(xs,", f"    {_SKIP}ln_rows<kThreads>(xs,")],
    # the weights' L2 loads replaced by a value from the loop counters
    "no_weight_loads": [("wk[j] = __ldg(wrow + cs[j]);", "wk[j] = (float)(k - cs[j]);"),
                        ("wv[j] = __ldg(w + k * cols + cs[j]);", "wv[j] = (float)(k - cs[j]);")],
    "no_products": [("    for (int k = 0; k < K; ++k) {\n      const float* wrow",
                     "    for (int k = 0; k < 0; ++k) {\n      const float* wrow"),
                    ("    for (int k = 0; k < K; ++k) {\n      float wv[kTileC];",
                     "    for (int k = 0; k < 0; ++k) {\n      float wv[kTileC];")],
}

# name -> (old, new) edits of this tree's fused_encoder.cu: parts of K4f
# left out (a product left out leaves the weight stream's later chunks to
# the products after it: only the count of chunks is right), p by a
# product for the division
VARIANTS = {
    "no_qkv": [("    for (int m = 0; m < 3; ++m) {\n      float* out = Q",
                "    for (int m = 0; m < 0; ++m) {\n      float* out = Q")],
    "no_attention": [("    attention<kTrain>(Q, Kb, V,",
                      f"    {_SKIP}attention<kTrain>(Q, Kb, V,")],
    "no_scores": [("item < nh * lt * lt; item += nt)", "item < 0; item += nt)")],
    "no_softmax": [("for (int base = 0; base < rows; base += groups)",
                    "for (int base = 0; base < 0; base += groups)")],
    "no_context": [("item < nh * lt * dt; item += nt)", "item < 0; item += nt)")],
    "p_by_product": [("          p[t] = div_fast(v[t], total, recip);",
                      "          p[t] = v[t] * total;")],
    "no_wo_ffn": [(f"    run_matrix(ws, layer_mat(P, li, {m}),",
                   f"    {_SKIP}run_matrix(ws, layer_mat(P, li, {m}),") for m in (3, 4, 5)],
    "no_layernorm": [("    ln_rows(X, ld, L, D,", f"    {_SKIP}ln_rows(X, ld, L, D,")],
    "no_products": [("        for (int kk = 0; kk < kn; kk += 4) {",
                     "        for (int kk = 0; kk < 0; kk += 4) {")],
    "no_staging": [(f"        stage_chunk<{w}, kFwdChunk>(buffer(s),",
                    f"        {_SKIP}stage_chunk<{w}, kFwdChunk>(buffer(s),") for w in (32, 64)],
    # the training stores left out, by kind
    "no_ln_stores": [("      if (xc_out) __stcs(", f"      {_SKIP}__stcs("),
                     ("      if (y_out) __stcs(", f"      {_SKIP}__stcs("),
                     ("    if (inv_out && lane == 0) __stcs(", f"    {_SKIP}__stcs(")],
    "no_epilogue_stores": [("        if (save) store_saved(sv +",
                            f"        {_SKIP}store_saved(sv +"),
                           ("      if (save) store_saved(sh +", f"      {_SKIP}store_saved(sh +")],
    "no_row_copies": [("    if (save) store_rows(", f"    {_SKIP}store_rows(")],
    # the forward's ring three chunks deep (at SASRec's shape then three
    # heads an attention pass, for two blocks an SM)
    "ring_3": [("constexpr int kRing = 2;", "constexpr int kRing = 3;")],
    # 32 weight rows a chunk (twice the barriers; at SASRec's shape then all
    # four heads an attention pass)
    "chunk_32": [("constexpr int kFwdChunk = 64;", "constexpr int kFwdChunk = 32;")],
    # the products' k loop unrolled 4 times, or not (2 in the kept source)
    "unroll_k4": [("#pragma unroll 2\n        for (int kk = 0; kk < kn; kk += 4) {",
                   "#pragma unroll 4\n        for (int kk = 0; kk < kn; kk += 4) {")],
    "unroll_k1": [("#pragma unroll 2\n        for (int kk = 0; kk < kn; kk += 4) {",
                   "#pragma unroll 1\n        for (int kk = 0; kk < kn; kk += 4) {")],
    # the saved activations stored as any other value, kept in L2
    "cached_stores": [('#include "kernel_common.cuh"\n',
                       '#include "kernel_common.cuh"\n#define __stcs(p, v) (*(p) = (v))\n')],
}

# The 64-column passes (every product but inner = 32's) on the tensor cores
# in split TF32: x = hi + lo, each a TF32 value, and x w = hi_x hi_w + hi_x
# lo_w + lo_x hi_w from three mma.sync m16n8k8, the small terms first; a
# warp takes (16-row, 8-column) tiles w, w + warps, ... of a pass's 4 x 8,
# its sums from the bias.  Other arithmetic than the float32 chains: held
# to the gates, not to the bits.
SPLIT_TF32 = r"""
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <class Epi>
__device__ void run_mat_tc(WeightStream& ws, const Mat& m, const float* in, int ldi, int L,
                           Epi epi) {
  constexpr int kTiles = 5;  // of a pass's 32 tiles, at least 7 warps
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int chunks = m.chunks(), passes = m.passes();
  for (int p = 0; p < passes; ++p) {
    float acc[kTiles][4];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int c = p * 64 + ((warp + i * nw) % 8) * 8 + 2 * t;
      const float b0 = c < m.C ? __ldg(m.b + c) : 0.0f;
      const float b1 = c + 1 < m.C ? __ldg(m.b + c + 1) : 0.0f;
      acc[i][0] = acc[i][2] = b0;
      acc[i][1] = acc[i][3] = b1;
    }
    for (int ch = 0; ch < chunks; ++ch) {
      const float* w0 = ws.begin();
      const int k0 = ch * kFwdChunk, kn = min(kFwdChunk, m.K - k0);
      for (int k8 = 0; k8 < kn; k8 += 8) {
#pragma unroll
        for (int i = 0; i < kTiles; ++i) {
          const int tile = warp + i * nw;
          if (tile >= 32 || (tile / 8) * 16 >= L) continue;
          const int r0 = min((tile / 8) * 16 + g, L - 1), r1 = min((tile / 8) * 16 + g + 8, L - 1);
          const float* a0 = in + r0 * ldi + k0 + k8 + t;
          const float* a1 = in + r1 * ldi + k0 + k8 + t;
          const float* b = w0 + (k8 + t) * 64 + (tile % 8) * 8 + g;
          uint32_t ah[4], al[4], bh[2], bl[2];
          split_tf32(a0[0], ah[0], al[0]);
          split_tf32(a1[0], ah[1], al[1]);
          split_tf32(a0[4], ah[2], al[2]);
          split_tf32(a1[4], ah[3], al[3]);
          split_tf32(b[0], bh[0], bl[0]);
          split_tf32(b[4 * 64], bh[1], bl[1]);
          mma_tf32(acc[i], ah, bl);
          mma_tf32(acc[i], al, bh);
          mma_tf32(acc[i], ah, bh);
        }
      }
      ws.end();
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int tile = warp + i * nw;
      const int row = (tile / 8) * 16 + g, c = p * 64 + (tile % 8) * 8 + 2 * t;
      if (tile >= 32 || c >= m.C) continue;
      const float top[2] = {acc[i][0], acc[i][1]}, bottom[2] = {acc[i][2], acc[i][3]};
      if (row < L) epi(row, c, top, min(2, m.C - c));
      if (row + 8 < L) epi(row + 8, c, bottom, min(2, m.C - c));
    }
  }
}

"""
VARIANTS["split_tf32"] = [
    ("template <class Epi>\n__device__ void run_matrix(",
     SPLIT_TF32 + "template <class Epi>\n__device__ void run_matrix("),
    ("    run_mat<4>(ws, m, in, ldi, L, epi);", "    run_mat_tc(ws, m, in, ldi, L, epi);")]


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


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def start_builds(sources: dict, out_dir: str = OUT) -> dict:
    """Start one nvcc a source text, all together, into ``out_dir`` (the
    shared headers from this tree's csrc/), with ptxas's report."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC_DIR),
               "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), lib)
    return procs


def finish_builds(procs: dict) -> tuple:
    """(name -> the loaded library, name -> ptxas's lines on its kernels, or
    nvcc's error for a variant that failed to build)."""
    libs, reports = {}, {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            if name in ("this", "parent"):
                raise RuntimeError(f"{name} failed to build:\n{err}")
            reports[name] = [f"failed to build: {err[-2000:]}"]
            continue
        libs[name] = ctypes.CDLL(lib)
        reports[name] = [line.strip() for line in err.splitlines()
                         if "registers" in line or "spill" in line or "Compiling entry" in line]
    return libs, reports


def shapes(dev, gen) -> dict:
    """name -> (x, key_valid, packed, options) at SASRec's and IOCRec's
    shapes; options as fused_encoder's (heads, causal, act, eps, hidden and
    attention dropout, seed)."""
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


def outputs(x, packed) -> dict:
    """Buffers for one tree's K4f outputs: y, y_train and saved."""
    N, L, D = x.shape
    layers, inner = packed[0].shape[0], packed[2].shape[-1]
    return {"y": torch.empty_like(x), "y_train": torch.empty_like(x),
            "saved": x.new_empty(layers, encoder.saved_floats(N * L, D, inner))}


def lib_calls(lib, x, kv, packed, opts, out) -> dict:
    """mode -> a call of ``lib``'s K4f entry points on these inputs into
    ``out`` (``outputs``): serving (no dropout), training with the stores
    and without them."""
    heads, causal, act, eps, hidden, attn, seed = opts
    N, L, D = x.shape
    layers, inner = packed[0].shape[0], packed[2].shape[-1]
    serve, train = lib.rp_fused_encoder_f32, lib.rp_fused_encoder_train_f32
    serve.argtypes = encoder._kernel().argtypes
    train.argtypes = encoder._train_kernel().argtypes
    serve.restype = train.restype = ctypes.c_int
    kvf = kv.float().contiguous()
    shape = (N, L, D, layers, heads, inner, int(causal), encoder.ACTIVATIONS[act], float(eps))
    weights = [t.data_ptr() for t in packed]
    drop = encoder._dropout_args(seed, hidden, attn)

    def check(err):
        if err:
            raise RuntimeError(f"K4f launch failed: CUDA error {err}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    return {
        "serving": lambda: check(serve(x.data_ptr(), kvf.data_ptr(), *weights,
                                       out["y"].data_ptr(), *shape, stream())),
        "training": lambda: check(train(x.data_ptr(), kvf.data_ptr(), *weights,
                                        out["y_train"].data_ptr(), out["saved"].data_ptr(),
                                        *shape, *drop, stream())),
        "training_no_save": lambda: check(train(x.data_ptr(), kvf.data_ptr(), *weights,
                                                out["y_train"].data_ptr(), None, *shape,
                                                *drop, stream())),
    }


def times(calls: dict, shape: str) -> dict:
    launches, reps = (10, 7) if shape == "iocrec" else (100, cs.TIMING_REPS)
    return {mode: cs.median_ms([fn], launches, reps) for mode, fn in calls.items()}


def check_tree(cases: dict) -> dict:
    """This tree's K4f through its wrappers against the plain version; a
    failed check is reported (under "failed") and the times still taken."""
    out = {}
    for shape, (x, kv, packed, opts) in cases.items():
        heads, causal, act, eps = opts[:4]
        enc = _Packed(packed, heads, act, eps)
        out[shape] = {}
        for mode, check in (
                ("serving", lambda: cs.check_encoder(x, kv, enc, causal, f"{shape}, serving")),
                ("training", lambda: cs.check_encoder_saved(x, kv, packed, opts,
                                                            f"{shape}, training"))):
            try:
                out[shape][mode] = check()
            except RuntimeError as err:
                out[shape][mode] = {"failed": str(err)[:2000]}
    return out


def variant_gates(lib, cases: dict) -> dict:
    """The gates a variant of other arithmetic must hold, with ``lib``'s
    forward bound into the wrapper: check_tree's, and at IOCRec's shape
    K4b on its saved activations against the plain autograd
    (chip_smoke.check_encoder_bwd_relu)."""
    kept = encoder._kernel(), encoder._train_kernel()
    serve, train = lib.rp_fused_encoder_f32, lib.rp_fused_encoder_train_f32
    serve.argtypes, train.argtypes = kept[0].argtypes, kept[1].argtypes
    serve.restype = train.restype = ctypes.c_int
    encoder._FN, encoder._TRAIN_FN = serve, train
    try:
        out = check_tree(cases)
        x, kv, packed, opts = cases["iocrec"]
        enc = cs.random_encoder(cs.SEQ_DIM, 2, 128, 3, "relu", cs.SEED + 47, x.device, 1e-12)
        try:
            out["iocrec"]["bwd_relu"] = cs.check_encoder_bwd_relu(
                x, kv, enc, "IOCRec shape, relu, dropout 0.5", cs.IOC_DROP)
        except RuntimeError as err:
            out["iocrec"]["bwd_relu"] = {"failed": str(err)[:2000]}
    finally:
        encoder._FN, encoder._TRAIN_FN = kept
    return out


class _Packed:
    """The attributes of a TransformerEncoder that check_encoder reads."""

    def __init__(self, packed, heads, act, eps):
        self._packed, self.n_heads, self.hidden_act, self.layer_norm_eps = (
            packed, heads, act, eps)

    def packed(self):
        return self._packed


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_encoder_fwd: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    variants = "--variants" in argv
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 120)
    cases = shapes(dev, gen)
    sources = {"this": (_build.CSRC_DIR / "fused_encoder.cu").read_text()}
    if variants:
        sources.update(edited(sources["this"], VARIANTS))
    if "--parent" in argv:
        tree = argv[argv.index("--parent") + 1]
        with open(os.path.join(tree, "rec_pangu_tpu_torch", "csrc", "fused_encoder.cu")) as f:
            sources["parent"] = f.read()
        if "--parent-variants" in argv:
            sources.update({f"parent_{k}": v
                            for k, v in edited(sources["parent"], PARENT_VARIANTS).items()})
    procs = start_builds(sources)  # while the wrapper's own build and checks run
    result = {"nvidia_smi": nvidia_smi(), "checks": check_tree(cases)}
    libs, result["ptxas"] = finish_builds(procs)
    if "split_tf32" in libs:
        result["split_tf32_gates"] = variant_gates(libs["split_tf32"], cases)
    result["times"] = {}
    result["parent_bits"] = {}
    for shape, (x, kv, packed, opts) in cases.items():
        mine = outputs(x, packed)
        calls = {name: lib_calls(lib, x, kv, packed, opts, mine) for name, lib in libs.items()}
        if "parent" in libs:
            theirs = outputs(x, packed)
            calls["parent"] = lib_calls(libs["parent"], x, kv, packed, opts, theirs)
            for name in ("this", "parent"):
                calls[name]["serving"]()
                calls[name]["training"]()
            torch.cuda.synchronize()
            result["parent_bits"][shape] = {k: bool(torch.equal(mine[k], theirs[k]))
                                            for k in mine}
            del theirs
        t = {}
        order = ["parent", "this", "this", "parent"] if "parent" in libs else ["this"]
        for i, name in enumerate(order):
            t[f"{name}_{i}"] = times(calls[name], shape)
        for name in libs:
            if name not in ("this", "parent"):
                t[name] = times(calls[name], shape)
        result["times"][shape] = t
        del calls, mine
    failed = [f"{s}/{m}" for s, v in result["checks"].items() for m, c in v.items()
              if "failed" in c]
    failed += [f"{s}/{k}" for s, v in result["parent_bits"].items() for k, ok in v.items()
               if not ok]
    result["failed"] = failed
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
