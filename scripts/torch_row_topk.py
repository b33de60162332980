"""The row top-k kernel alone on one CUDA card.

    python3 scripts/torch_row_topk.py [--variants] [--compare SOURCE]

Prints the card's name and power limit and ptxas's register and spill report
of ``csrc/row_topk.cu``, runs ``chip_smoke.phase_row_topk`` (the kernel
against its plain version and torch.topk at retrieval's shape, [1,024,
1,000,000] cosine scores and top-200, and at edge cases; times of the kernel,
the plain version and torch.topk beside the one-read bound; a failed check is
reported, not raised), and times the kernel at that shape with other
numbers of slices a row.  ``--variants`` also times edited copies of the
source (VARIANTS: the launches cut after a stage), so the stages' times
show as differences.  Variants build into
``build/row_topk_variants/`` (gitignored).  ``--compare SOURCE`` times
another source of the same C interface (an older ``row_topk.cu``) between
two timings of this tree's.  Prints one JSON line, and one more for each
option; exits with 1 if a check failed.
"""
import json
import os
import sys
import traceback

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rec_pangu_tpu_torch.eval.retrieval import l2_normalize  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import _build  # noqa: E402
from rec_pangu_tpu_torch.ops.kernels import row_topk as rtk  # noqa: E402
from rec_pangu_tpu_torch.serving.scorer import score_items  # noqa: E402
from torch_encoder_bwd import build_sources, edited, nvidia_smi, ptxas_report  # noqa: E402

OUT = os.path.join(ROOT, "build", "row_topk_variants")
SLICES = (2, 4, 8, 16, 32)

# name -> (old, new) edits of this tree's row_topk.cu
_LEVEL0 = ("  threshold_kernel<<<(unsigned)B, kThreads, 0, st>>>(0, k, w, refined);\n")
_FILTER = ("  filter_kernel<kVec><<<(unsigned)(B * slices), kThreads, 0, st>>>(scores, N, "
           "slice_len, slices,\n")
VARIANTS = {
    # the first histogram alone
    "histogram_only": [(_LEVEL0, "  return cudaGetLastError();\n" + _LEVEL0)],
    # everything before the filter: the histogram, the thresholds, the empty levels
    "before_filter": [(_FILTER, "  return cudaGetLastError();\n" + _FILTER)],
}


def runner(fn, scores, k, slices):
    """A call of the library function ``fn`` on ``scores`` (its buffers made
    once)."""
    B, N = scores.shape
    values = torch.empty(B, k, device=scores.device)
    ids = torch.empty(B, k, dtype=torch.int32, device=scores.device)
    words = rtk.workspace_words(B, N)
    work = torch.empty(words, device=scores.device)
    refined = torch.zeros(1, dtype=torch.int64, device=scores.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(scores.data_ptr(), values.data_ptr(), ids.data_ptr(), work.data_ptr(), words,
                 B, N, k, rtk.CAPACITY, slices, refined.data_ptr(), stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    return call


def main() -> int:
    out = {"card": nvidia_smi(), "ptxas": ptxas_report(_build.CSRC_DIR / "row_topk.cu")}
    bandwidth = cs.peak_bandwidth(torch.cuda.get_device_name(0))
    failed = False
    try:
        out["row"] = cs.phase_row_topk(bandwidth)
    except Exception:  # report the failed check, keep the timings
        out["row_error"] = traceback.format_exc()
        failed = True
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 141)
    B, N, k = cs.SEQ_BATCH, cs.SEQ_VOCAB, cs.SEQ_TOPK
    scores = score_items(l2_normalize(torch.randn(B, cs.SEQ_DIM, generator=gen, device=dev)),
                         l2_normalize(torch.randn(N, cs.SEQ_DIM, generator=gen, device=dev)))
    kept = rtk.bind(_build.load("row_topk"))
    out["bound_ms"] = scores.numel() * 4 / bandwidth * 1e3
    out["slices_ms"] = {s: cs.events_ms(runner(kept, scores, k, s), 20)
                        for s in sorted({rtk.plan_slices(B, N), *SLICES})}
    print(json.dumps(out), flush=True)
    if "--variants" in sys.argv:
        libs = build_sources(edited((_build.CSRC_DIR / "row_topk.cu").read_text(), VARIANTS),
                             OUT)
        slices = rtk.plan_slices(B, N)
        times = {"kept": cs.events_ms(runner(kept, scores, k, slices), 20)}
        for name, lib in libs.items():
            times[name] = cs.events_ms(runner(rtk.bind(lib), scores, k, slices), 20)
        times["kept_again"] = cs.events_ms(runner(kept, scores, k, slices), 20)
        print(json.dumps({"variants_ms": times}), flush=True)
    if "--compare" in sys.argv:  # another source of the same C interface, timed between ours
        path = sys.argv[sys.argv.index("--compare") + 1]
        other = rtk.bind(build_sources({"compare": open(path).read()}, OUT)["compare"])
        slices = rtk.plan_slices(B, N)
        times = {}
        for name, fn in (("kept", kept), ("compare", other), ("compare_again", other),
                         ("kept_again", kept)):
            times[name] = cs.events_ms(runner(fn, scores, k, slices), 20)
        print(json.dumps({"compare": path, "compare_ms": times}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
