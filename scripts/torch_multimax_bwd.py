"""K5f and K5b, the K-max CE's forward and backward, alone on one CUDA card.

    python3 scripts/torch_multimax_bwd.py [--variants] [--parent TREE] [--step]

At the bench shape (1024 users x 4 interests x 64 against the raw
[1,007,616, 64] table, 1,000,000 valid items, row 0 read as zero): prints
ptxas's register and spill report of ``csrc/multimax_ce.cu``, holds K5f and
K5b against their plain versions (``chip_smoke.check_multimax``) and each
launch of K5b against its stage's plain version
(``chip_smoke.check_multimax_stages``; a failed check is reported, not
raised), and times K5f, K5b whole and launch by launch over its workspace
chunks (P: the pairs, U: the du product, S: the ordered du sum, D: d_items;
``chip_smoke.mm_bwd_parts``) and the plain versions.  Prints one JSON line;
exits with 1 if a check of this tree failed.

``--variants`` also times K5f from edited copies of the source (VARIANTS:
parts left out, unrolling, grids or launch bounds) and holds
each against the plain version at an edge shape of large scores (``EDGE``:
chip_smoke's 5 users x 1 interest x 128 against 300 unscaled items); the
copies with parts left out are wrong by design there.  ``--parent TREE``
times an older tree's K5f and K5b (the same C interface, built from
``TREE/rec_pangu_tpu_torch/csrc/multimax_ce.cu``) with its ptxas report,
between two timings of this tree's (this, parent, this).  Variants and the
parent build into ``build/k5_variants/`` (gitignored).  ``--step`` (with
``--parent``) runs IOCRec's ``fit`` at the bench shape in each tree, one
process each (the tree's own ``chip_smoke.phase_model_training``: 8 fused
steps and one valid batch): the fused step's p50 and the peak allocation.
"""
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
from torch_encoder_bwd import build_sources, edited, nvidia_smi, ptxas_report  # noqa: E402

OUT = os.path.join(ROOT, "build", "k5_variants")

# name -> (old, new) edits of this tree's multimax_ce.cu (ZTile, K5f)
VARIANTS = {
    # no products: the staging, the epilogue and the online softmax alone
    "no_products": [("    for (int d = 0; d < dp; d += 4) {", "    for (int d = 0; d < 0; d += 4) {")],
    # no copy of the next tile: the products run on a stale slot
    "no_staging": [("    if (tile + 1 < last) stage(tile + 1);", "")],
    "unroll_2": [("    for (int d = 0; d < dp; d += 4) {",
                  "#pragma unroll 2\n    for (int d = 0; d < dp; d += 4) {")],
    "unroll_1": [("    for (int d = 0; d < dp; d += 4) {",
                  "#pragma unroll 1\n    for (int d = 0; d < dp; d += 4) {")],
    # the online softmax's exponentials by the fast intrinsic
    "fast_exp": [("        for (int j = 0; j < 8; ++j) e += expf(z[q][j] - m_new);\n"
                  "        s[q] = s[q] * expf(m[q] - m_new) + half_sum(e);",
                  "        for (int j = 0; j < 8; ++j) e += __expf(z[q][j] - m_new);\n"
                  "        s[q] = s[q] * __expf(m[q] - m_new) + half_sum(e);")],
    # other block counts of the forward's grid
    "blocks_1056": [("constexpr int kFwdTargetBlocks = 2112;", "constexpr int kFwdTargetBlocks = 1056;")],
    "blocks_4224": [("constexpr int kFwdTargetBlocks = 2112;", "constexpr int kFwdTargetBlocks = 4224;")],
    "one_block": [("__launch_bounds__(kThreads, 2) lse_partial_kernel",
                   "__launch_bounds__(kThreads, 1) lse_partial_kernel")],
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


def bench_inputs(dev):
    """(u, table, lse) at the bench shape, as chip_smoke.phase_multimax_ce
    draws them."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 110)
    table = torch.randn(padded_rows(cs.SEQ_VOCAB), cs.SEQ_DIM, generator=gen,
                        device=dev) * (2.0 / cs.SEQ_DIM) ** 0.5
    u = torch.randn(cs.SEQ_BATCH, 4, cs.SEQ_DIM, generator=gen, device=dev) * 0.5
    return u, table, mmce.multimax_lse(u, table, cs.SEQ_VOCAB, True)


def k5f_ms(u, table) -> float:
    """K5f of the library bound in ``mmce`` now, ms a call."""
    return cs.median_ms([lambda: mmce.launch_lse(u, table, cs.SEQ_VOCAB, True)],
                        cs.MM_LAUNCHES, 5)


def kernel_times(u, table, lse) -> dict:
    """K5f, K5b and K5b's launches of the library bound in ``mmce`` now, ms a
    call."""
    v = cs.SEQ_VOCAB
    return {"k5f": k5f_ms(u, table),
            "k5b": cs.median_ms([lambda: mmce.launch_grads(u, table, lse, v, True)],
                                cs.MM_LAUNCHES, 5),
            "parts": cs.mm_bwd_parts(u, table, lse, v, True)}


def attempt(check) -> dict:
    """check()'s result, or the failure it raised (the times are still
    taken)."""
    try:
        return check()
    except RuntimeError as err:
        return {"failed": str(err)}


def with_library(lib, fn):
    """fn() with ``lib``'s functions bound in place of the kept build's."""
    kept = mmce._functions()
    mmce._LSE_FN, mmce._GRADS_FN = mmce.bind(lib)
    try:
        return fn()
    finally:
        mmce._LSE_FN, mmce._GRADS_FN = kept


# chip_smoke.phase_multimax_ce's edge case whose scores reach |z| of 17
EDGE = (5, 1, 128, 300, 257)


def edge_check(dev) -> dict:
    B, K, D, rows, valid = EDGE
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 111)
    u = torch.randn(B, K, D, generator=gen, device=dev) * 0.5
    items = torch.randn(rows, D, generator=gen, device=dev)
    return attempt(lambda: cs.check_multimax(u, items, valid, True, "edge"))


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
    result["check"] = attempt(lambda: cs.check_multimax(u, table, cs.SEQ_VOCAB, True,
                                                        "bench shape"))
    result["stages"] = attempt(lambda: cs.check_multimax_stages(u, table, cs.SEQ_VOCAB, True,
                                                                "bench shape"))
    result["new"] = kernel_times(u, table, lse)
    result["plain"] = {
        "k5f": cs.median_ms([lambda: mmce.multimax_lse_reference(u, table, cs.SEQ_VOCAB, True)],
                            cs.MM_LAUNCHES, 3),
        "k5b": cs.median_ms([lambda: mmce.multimax_grads_reference(u, table, lse, cs.SEQ_VOCAB,
                                                                   True)], cs.MM_LAUNCHES, 3)}
    if "--variants" in argv:
        libs = build_sources(edited((_build.CSRC_DIR / "multimax_ce.cu").read_text(), VARIANTS),
                             OUT)
        result["variants"] = {
            name: with_library(lib, lambda: {"k5f": k5f_ms(u, table),
                                             "edge": edge_check(u.device)})
            for name, lib in libs.items()}
    result["edge"] = edge_check(u.device)
    if "--parent" in argv:
        tree = argv[argv.index("--parent") + 1]
        source = os.path.join(tree, "rec_pangu_tpu_torch", "csrc", "multimax_ce.cu")
        lib = build_sources({"parent": open(source).read()}, OUT)["parent"]
        result["parent"] = {"ptxas": ptxas_report(source),
                            **with_library(lib, lambda: kernel_times(u, table, lse))}
        result["new_again"] = kernel_times(u, table, lse)
        if "--step" in argv:
            del u, table, lse
            torch.cuda.empty_cache()
            result["step"] = {"parent": step_times(tree), "new": step_times(ROOT)}
    print(json.dumps(result))
    # a failed check of this tree fails the run (the variants are reported only)
    return int(any("failed" in result[key] for key in ("check", "stages", "edge")))


def step_times(tree: str) -> dict:
    """IOCRec's fit in ``tree``, in a process of its own (see STEP_RUN)."""
    tmp = os.path.join(ROOT, "build")
    os.makedirs(tmp, exist_ok=True)
    done = subprocess.run([sys.executable, "-c", STEP_RUN, os.path.abspath(tree), tmp],
                          capture_output=True, text=True, timeout=900)
    if done.returncode:
        raise RuntimeError(f"the IOCRec fit in {tree} failed:\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
