"""K6f, the global-attention forward, alone on one CUDA card.

Builds ``csrc/global_attn.cu``, prints ptxas's register and spill report of
its forward kernels, then holds both variants of the forward (wk and wv kept
in shared memory, and streamed from device memory) against the plain version
at IOCRec's training shape (3072 views of 50 x 64, dropout 0.5) and at the
edges of its partition (G - 1, G, G + 1 and 2 G + 1 views, G the forward's
groups on this card), and times them at the training shape and the serving
shape (1024 views, no dropout) beside the plain version and the library call
(``F.linear`` twice and ``scaled_dot_product_attention``) exactly as
``chip_smoke.py`` does.  Prints one JSON line.

    python3 scripts/torch_global_attn_fwd.py [--variants]

``--variants`` also times copies of the source edited to find what holds
the kernel back (VARIANTS: the products, the x loads, the softmax or the y
stores left out; one, three or four groups a block; groups of 128 threads;
the group barriers left out).  Their results are wrong by design; only their
times are read.  They build where ``scripts/torch_global_attn_bwd.py`` builds
its own.
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
from torch_global_attn_bwd import build_variants, kernel_registers  # noqa: E402

SOURCE = _build.CSRC_DIR / "global_attn.cu"

# name -> (old, new) edits of csrc/global_attn.cu, every occurrence of old
VARIANTS = {
    "no_products": [("for (int k = 0; k < K; k += 4) {", "for (int k = 0; k < 0; k += 4) {")],
    "no_x_loads": [("for (int i = t; i < Lp * dq; i += kGT) {",
                    "for (int i = t; i < 0; i += kGT) {")],
    "no_softmax": [("for (int l = quarter; l < Lp; l += 4 * (kGT / 32)) {",
                    "for (int l = quarter; l < 0; l += 4 * (kGT / 32)) {")],
    "no_y_stores": [("if (c < D)\n            *reinterpret_cast<float4*>(yg + l * D + c) =",
                     "if (c < D && F.n < 0)\n            *reinterpret_cast<float4*>(yg + l * D + c) =")],
    "one_group": [("constexpr int kFwdGroups = 4;", "constexpr int kFwdGroups = 1;")],
    "three_groups": [("constexpr int kFwdGroups = 4;", "constexpr int kFwdGroups = 3;")],
    "groups_of_128": [("constexpr int kFwdGroupThreads = 256;",
                       "constexpr int kFwdGroupThreads = 128;")],
    "no_barriers": [('asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "n"(kGT) : "memory");',
                     "(void)g;")],
}


def ptxas_report() -> list:
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    cmd = [_build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", os.devnull, str(SOURCE)]
    log = subprocess.run(cmd, capture_output=True, text=True, timeout=600).stderr
    return kernel_registers(log, "fwd_kernel")


def variant_times(libs: dict, regs: dict, x, params) -> dict:
    """Each variant's time through launch_forward at the training shape, its
    library swapped in."""
    gattn._functions()
    kept = gattn._FWD_FN
    times = {"registers": regs}
    try:
        for name, lib in libs.items():
            gattn._FWD_FN = gattn._bind_forward(lib)
            times[name] = cs.median_ms([lambda: gattn.launch_forward(x, params, cs.IOC_DROP, 7)])
    finally:
        gattn._FWD_FN = kept
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_global_attn_fwd: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    variants = build_variants(VARIANTS, "fwd_kernel") if "--variants" in sys.argv[1:] else None
    report = ptxas_report()
    _build.build_all(["global_attn"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 100)
    L, D, N = cs.SEQ_L, cs.SEQ_DIM, cs.IOC_VIEWS
    params = cs.ga_params(D, L, gen)
    x = torch.randn(N, L, D, generator=gen, device=dev) * (2.0 / D) ** 0.5
    serving = x[:cs.SEQ_BATCH]
    groups = gattn.forward_groups(N, L, D)
    checks = {}
    for resident in (True, False):
        for n in (N, groups - 1, groups, groups + 1, 2 * groups + 1):
            case = cs.check_ga_forward(x[:n], params, cs.IOC_DROP, resident,
                                       f"N={n} resident={resident}")
            checks[case["case"]] = case["y_abs"]
    cs.require_equal(gattn.launch_forward(x, params, cs.IOC_DROP, 7, resident=True),
                     gattn.launch_forward(x, params, cs.IOC_DROP, 7, resident=False),
                     "resident and streamed variants")

    def library(xs):
        with torch.no_grad():
            cs.ga_library(xs, params)

    t = {f"resident={r}": cs.median_ms(
        [lambda r=r: gattn.launch_forward(x, params, cs.IOC_DROP, 7, resident=r)])
        for r in (None, True, False)}
    t["serving"] = cs.median_ms([lambda: gattn.launch_forward(serving, params, 0.0, 0)])
    t["library_serving"] = cs.median_ms([lambda: library(serving)])
    t["library"] = cs.median_ms([lambda: library(x)])
    with torch.no_grad():
        t["plain"] = cs.median_ms(
            [lambda: gattn.global_attn_reference(x, params, True, cs.IOC_DROP, 7)])
    if variants:
        t["variants"] = variant_times(*variants, x, params)
    peak = cs.peak_fp32(torch.cuda.get_device_name(0))
    bound_ms = {"training": cs.ga_work(N, L, D) / peak * 1e3,
                "serving": cs.ga_work(cs.SEQ_BATCH, L, D) / peak * 1e3}
    print(json.dumps({"nvidia_smi": smi, "ptxas": report, "groups": groups,
                      "max_abs_err": checks, "ms": t, "bound_ms": bound_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
