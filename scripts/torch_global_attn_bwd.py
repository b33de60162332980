"""K6b, the global-attention backward, alone on one CUDA card.

Builds ``csrc/global_attn.cu``, prints ptxas's register and spill report of
its kernels, then holds both variants of the backward (wk and wv kept in
shared memory, and streamed from device memory) against the plain version's
autograd at IOCRec's training shape (3072 views of 50 x 64, dropout 0.5) and
at the partition's edges, and times them beside the plain version and the
library call (``F.linear`` twice and ``scaled_dot_product_attention``, under
autograd) exactly as ``chip_smoke.py`` does.  Prints one JSON line.

    python3 scripts/torch_global_attn_bwd.py [--variants]

``--variants`` also times copies of the source edited to find what holds
the kernel back (VARIANTS: one group a block; 4 x 8 register tiles for
the products D wide; dQ's sums in registers; the products, the sample
loads, the k and v epilogue's bias reads, the softmax and dS row passes or
the group barriers left out; the product loop not unrolled).  Their results are wrong
by design; only their times are read.  They build into
``chiprun_out/ga_variants/``.
"""
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import _build  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import global_attn as gattn  # noqa: E402


def ptxas_report() -> list:
    """ptxas's lines on the backward's kernels (registers, spills, shared memory)."""
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    cmd = [_build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", os.devnull,
           str(_build.CSRC_DIR / "global_attn.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True, timeout=600).stderr
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


# name -> (old, new) edits of csrc/global_attn.cu, every occurrence of old
VARIANTS = {
    "one_group": [("launch_bwd<2, true, 8 / kTw, 0>", "launch_bwd<1, true, 8 / kTw, 0>"),
                  ("b.blocks = b.resident ? (b.slices + 1) / 2 : b.slices;",
                   "b.blocks = b.slices;"),
                  ("2 * b.Dp * b.ld + 2 * sample_floats(", "2 * b.Dp * b.ld + sample_floats(")],
    "no_products": [("for (int k = 0; k < K; k += 4) {", "for (int k = 0; k < 0; k += 4) {")],
    "no_loads": [("const int dq = D / 4, quads = L * dq;", "const int dq = D / 4, quads = 0;")],
    "tiles_4x8": [("constexpr int kTw = 4;", "constexpr int kTw = 8;")],
    "no_bias_reads": [("acc[r][j] + (c < D ? bias[c] : 0.0f)", "acc[r][j]")],
    "dq_in_registers": [("launch_bwd<2, true, 8 / kTw, 0>", "launch_bwd<2, true, 8 / kTw, 1>"),
                        ("2 * sample_floats(b.Lp, b.Dp, b.ld, true))",
                         "2 * sample_floats(b.Lp, b.Dp, b.ld, false))")],
    "k_loop_not_unrolled": [("  for (int k = 0; k < K; k += 4) {",
                             "#pragma unroll 1\n  for (int k = 0; k < K; k += 4) {")],
    "no_row_passes": [("for (int l = quarter; l < Lp; l += 4 * kGroupWarps) {",
                       "for (int l = quarter; l < 0; l += 4 * kGroupWarps) {"),
                      ("for (int l = quarter; l < Lp; l += 4 * (kGT / 32)) {",
                       "for (int l = quarter; l < 0; l += 4 * (kGT / 32)) {")],
    "no_barriers": [('asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "n"(kGT) : "memory");',
                     "(void)g;")],
}


def kernel_registers(log: str, kernel: str) -> list:
    """ptxas's properties and registers of each kernel named `kernel` in `log`."""
    lines = log.splitlines()
    return [" ".join(x.strip() for x in lines[i + 1:i + 3])
            for i, line in enumerate(lines) if "Function properties for" in line and kernel in line]


def build_variants(variants: dict = VARIANTS, kernel: str = "bwd_kernel") -> tuple:
    """(name -> the loaded library of each edited copy, name -> ptxas's
    register lines on its kernels named `kernel`), built in parallel."""
    import ctypes

    out = os.path.join(ROOT, "chiprun_out", "ga_variants")
    os.makedirs(out, exist_ok=True)
    src = (_build.CSRC_DIR / "global_attn.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out, f"lib{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC_DIR),
               "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), lib)
    libs, regs = {}, {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{err}")
        libs[name] = ctypes.CDLL(lib)
        regs[name] = kernel_registers(err, kernel)
    return libs, regs


def variant_times(libs: dict, regs: dict, x, params, dy) -> dict:
    """Each variant's time through launch_backward, its library swapped in."""
    gattn._functions()
    kept = gattn._BWD_FN
    times = {"registers": regs}
    try:
        for name, lib in libs.items():
            bwd, words = lib.rp_global_attn_bwd_f32, lib.rp_global_attn_bwd_workspace_words
            bwd.argtypes, bwd.restype = kept[0].argtypes, kept[0].restype
            words.argtypes, words.restype = kept[1].argtypes, kept[1].restype
            gattn._BWD_FN = (bwd, words)
            times[name] = cs.median_ms(
                [lambda: gattn.launch_backward(x, params, dy, cs.IOC_DROP, 7)])
    finally:
        gattn._BWD_FN = kept
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_global_attn_bwd: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    variants = build_variants() if "--variants" in sys.argv[1:] else None
    report = ptxas_report()
    _build.build_all(["global_attn"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 100)
    L, D, N = cs.SEQ_L, cs.SEQ_DIM, cs.IOC_VIEWS
    params = cs.ga_params(D, L, gen)
    x = torch.randn(N, L, D, generator=gen, device=dev) * (2.0 / D) ** 0.5
    dy = torch.randn(N, L, D, generator=gen, device=dev)
    checks = {}
    for resident in (True, False):
        for n in (N, cs.GA_SLICES - 1, cs.GA_SLICES, cs.GA_SLICES + 1, 2 * cs.GA_SLICES + 1):
            case = cs.check_ga_backward(x[:n], params, dy[:n], cs.IOC_DROP, resident,
                                        f"N={n} resident={resident}")
            checks[case["case"]] = max(v for k, v in case.items() if k != "case")
    t = {f"resident={r}": cs.median_ms(
        [lambda r=r: gattn.launch_backward(x, params, dy, cs.IOC_DROP, 7, resident=r)])
        for r in (None, True, False)}
    t.update(cs.ga_reference_times(x, params, dy))
    if variants:
        t["variants"] = variant_times(*variants, x, params, dy)
    flop = cs.ga_bwd_work(N, L, D)
    bound_ms = flop / cs.peak_fp32(torch.cuda.get_device_name(0)) * 1e3
    print(json.dumps({"nvidia_smi": smi, "ptxas": report, "max_rel_err": checks, "ms": t,
                      "bound_ms": bound_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
