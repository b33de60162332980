"""K5b, the K-max CE backward, alone on one CUDA card.

    python3 scripts/torch_multimax_bwd.py [--variants] [--parent TREE] [--step]

At the bench shape (1024 users x 4 interests x 64 against the raw
[1,007,616, 64] table, 1,000,000 valid items, row 0 read as zero): prints
ptxas's register and spill report of ``csrc/multimax_ce.cu``, holds each
launch of K5b against its stage's plain version
(``chip_smoke.check_multimax_stages``), and times K5b whole, launch by
launch over its workspace chunks (P: the pairs, U: the du product, S:
the ordered du sum, D: d_items; ``chip_smoke.mm_bwd_parts``), its plain version
and K5f.  Prints one JSON line.

``--variants`` also times the launches from edited copies of the source
(VARIANTS: parts left out, U's and D's staging left out, other unrolling
or launch bounds).  ``--parent TREE`` times
an older tree's two-launch K5b (``TREE/rec_pangu_tpu_torch/csrc/
multimax_ce.cu``) with its ptxas report, and with ``--variants`` copies of
it with one launch left out (PARENT_VARIANTS).  The variants' results are
wrong by design; only their times are read.  They build into
``build/k5b_variants/`` (gitignored).  ``--step`` (with ``--parent``) runs
IOCRec's ``fit`` at the bench shape in each tree, one process each (the
tree's own ``chip_smoke.phase_model_training``: 8 fused steps and one
valid batch): the fused step's p50 and the peak allocation.
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
from rec_pangu_tpu_torch.ops.embedding import padded_rows  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import _build  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import multimax_ce as mmce  # noqa: E402
from torch_encoder_bwd import build_sources, edited, nvidia_smi  # noqa: E402

OUT = os.path.join(ROOT, "build", "k5b_variants")

_SKIP = "if (false) "
# name -> (old, new) edits of the older tree's multimax_ce.cu
PARENT_VARIANTS = {
    "no_items_grad": [("  items_grad_kernel<K><<<", f"  {_SKIP}items_grad_kernel<K><<<")],
    "no_users_grad": [("  users_grad_kernel<K><<<", f"  {_SKIP}users_grad_kernel<K><<<")],
}

# name -> (old, new) edits of this tree's multimax_ce.cu
VARIANTS = {
    "p_no_z": [("    tile_z<K>(A, tt, base, z, ks);",
                "    for (int s_ = 0; s_ < kTU; ++s_)\n      for (int j_ = 0; j_ < 8; ++j_) {\n"
                "        z[s_][j_] = 0.0f;\n        ks[s_][j_] = (tx + j_) % K;\n      }")],
    "p_no_stores": [("        __stcs(wp + at, live ? expf(z[s][j] - l[s]) : 0.0f);\n"
                     "        wk[at] = (unsigned char)ks[s][j];",
                     "        if (z[s][j] == 1.2345f) wk[at] = (unsigned char)ks[s][j];")],
    "u_no_products": [("      for (int i = 0; i < SI; ++i) {", "      for (int i = 0; i < 0; ++i) {")],
    "d_no_products": [("      for (int b = 0; b < SU; ++b) {", "      for (int b = 0; b < 0; ++b) {")],
    "u_no_staging": [("      if (st + 1 < stages) {", "      if (false) {")],
    "d_no_staging": [("      if (s + 1 < stages) {", "      if (false) {")],
    "u_unroll_1": [("#pragma unroll 2\n      for (int i = 0; i < SI; ++i) {",
                    "#pragma unroll 1\n      for (int i = 0; i < SI; ++i) {")],
    "d_unroll_1": [("#pragma unroll 2\n      for (int b = 0; b < SU; ++b) {",
                    "#pragma unroll 1\n      for (int b = 0; b < SU; ++b) {")],
    "d_bounds_1": [("__launch_bounds__(kThreads, 2)\n    items_kernel",
                    "__launch_bounds__(kThreads, 1)\n    items_kernel")],
}

STEP_RUN = r'''
import json, os, sys, tempfile, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs._build.build_all()
with tempfile.TemporaryDirectory(dir=sys.argv[2]) as tmp:
    path = os.path.join(tmp, "iocrec.ckpt")
    enc = cs.write_model_checkpoint(path, "IOCRec", cs.IOC_CONFIG, cs.SEED + 90)
    torch.cuda.reset_peak_memory_stats()
    summary, _ = cs.phase_model_training(
        path, enc, os.path.join(tmp, "ckpt"), "IOCRec", cs.IOC_CONFIG,
        ("fused_adam", "fused_encoder_bwd", "global_attn_bwd", "multimax_ce", "multimax_ce_bwd"),
        ("embedding_lookup", "fused_encoder", "global_attn"), cs.SEED + 92)
    print(json.dumps({"fused": summary["fused"], "peak_allocated_bytes":
                      torch.cuda.max_memory_allocated()}))
'''


def ptxas_report(source) -> list:
    """ptxas's lines on the source's kernels (registers, spills, shared memory)."""
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    cmd = [_build._nvcc(), *flags, "-Xptxas", "-v", "-I", str(_build.CSRC_DIR), "-c", "-o",
           os.devnull, str(source)]
    log = subprocess.run(cmd, capture_output=True, text=True, timeout=600).stderr
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def bench_inputs(dev):
    """(u, table, lse) at the bench shape, as chip_smoke.phase_multimax_ce
    draws them."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 110)
    table = torch.randn(padded_rows(cs.SEQ_VOCAB), cs.SEQ_DIM, generator=gen,
                        device=dev) * (2.0 / cs.SEQ_DIM) ** 0.5
    u = torch.randn(cs.SEQ_BATCH, 4, cs.SEQ_DIM, generator=gen, device=dev) * 0.5
    return u, table, mmce.multimax_lse(u, table, cs.SEQ_VOCAB, True)


def new_times(u, table, lse) -> dict:
    stages = cs.check_multimax_stages(u, table, cs.SEQ_VOCAB, True, "bench shape")
    v = cs.SEQ_VOCAB
    return {
        "stages": stages,
        "k5b": cs.median_ms([lambda: mmce.launch_grads(u, table, lse, v, True)],
                            cs.MM_LAUNCHES, 5),
        "parts": cs.mm_bwd_parts(u, table, lse, v, True),
        "plain": cs.median_ms([lambda: mmce.multimax_grads_reference(u, table, lse, v, True)],
                              cs.MM_LAUNCHES, 3),
        "k5f": cs.median_ms([lambda: mmce.launch_lse(u, table, v, True)], cs.MM_LAUNCHES, 5),
    }


def variant_times(u, table, lse) -> dict:
    """P, U, S and D alone (chip_smoke.mm_bwd_parts) with each variant's
    library bound in place of the kept one."""
    libs = build_sources(edited((_build.CSRC_DIR / "multimax_ce.cu").read_text(), VARIANTS),
                         OUT)
    kept = mmce._functions()
    out = {}
    try:
        for name, lib in libs.items():
            mmce._LSE_FN, mmce._GRADS_FN = mmce.bind(lib)
            out[name] = cs.mm_bwd_parts(u, table, lse, cs.SEQ_VOCAB, True)
    finally:
        mmce._LSE_FN, mmce._GRADS_FN = kept
    return out


def parent_times(tree: str, variants: bool, u, table, lse) -> dict:
    """The older tree's two-launch K5b (and its copies with one launch left
    out) at the bench shape."""
    source = os.path.join(tree, "rec_pangu_tpu_torch", "csrc", "multimax_ce.cu")
    text = open(source).read()
    sources = {"parent": text, **(edited(text, PARENT_VARIANTS) if variants else {})}
    libs = build_sources(sources, OUT)
    B, K, D = u.shape
    rows = table.shape[0]
    du, d_items = torch.empty_like(u), torch.empty_like(table)
    out = {"ptxas": ptxas_report(source)}
    for name, lib in libs.items():
        fn, words = lib.rp_multimax_grads_f32, lib.rp_multimax_grads_workspace_words
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        words.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
        words.restype = ctypes.c_longlong
        work = torch.empty(words(B, K, D, rows), device=u.device)

        def call(fn=fn, work=work):
            err = fn(u.data_ptr(), table.data_ptr(), lse.data_ptr(), du.data_ptr(),
                     d_items.data_ptr(), work.data_ptr(), work.numel(), B, K, D, rows,
                     cs.SEQ_VOCAB, 1, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        out[name] = cs.median_ms([call], cs.MM_LAUNCHES, 5)
    return out


def step_times(tree: str) -> dict:
    """IOCRec's fit in ``tree``, in a process of its own (see STEP_RUN)."""
    tmp = os.path.join(ROOT, "build")
    os.makedirs(tmp, exist_ok=True)
    done = subprocess.run([sys.executable, "-c", STEP_RUN, os.path.abspath(tree), tmp],
                          capture_output=True, text=True, timeout=900)
    if done.returncode:
        raise RuntimeError(f"the IOCRec fit in {tree} failed:\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_multimax_bwd: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    u, table, lse = bench_inputs(torch.device("cuda"))
    result = {"nvidia_smi": nvidia_smi(),
              "ptxas": ptxas_report(_build.CSRC_DIR / "multimax_ce.cu"),
              "plan": mmce.grads_plan(*u.shape, table.shape[0])._asdict()}
    result["new"] = new_times(u, table, lse)
    if "--variants" in argv:
        result["variants"] = variant_times(u, table, lse)
    if "--parent" in argv:
        tree = argv[argv.index("--parent") + 1]
        result["parent"] = parent_times(tree, "--variants" in argv, u, table, lse)
        if "--step" in argv:
            del u, table, lse
            torch.cuda.empty_cache()
            result["step"] = {"parent": step_times(tree), "new": step_times(ROOT)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
