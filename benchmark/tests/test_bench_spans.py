"""The per-layer metrics that read the program's spans, on a tiny traced
run of each cell on the CPU: the host times are there, the device times are
not (no card), and a program without spans reads nothing."""
import sys

import pytest

from benchmark.tests.tiny import OVERRIDES, bench, run_cell

HOST = {"sasrec_1m.train": "upload_host_ms.train", "sasrec_1m.retrieve": "upload_host_ms.serve"}
DEVICE = {"sasrec_1m.train": ("ce_fwd_ms.train", "ce_bwd_ms.train", "ce_gemm_ms.train"),
          "sasrec_1m.retrieve": ("encode_ms.serve", "score_ms.serve")}


@pytest.mark.parametrize("name", sorted(OVERRIDES))
def test_span_metrics_on_the_cpu(name):
    result = run_cell(name, trace=True)
    assert result["metrics"][HOST[name]]["value"] > 0
    assert not set(DEVICE[name]) & set(result["metrics"])


@pytest.mark.parametrize("name", sorted(OVERRIDES))
def test_a_program_without_spans_reads_nothing(name, monkeypatch):
    import rec_pangu_tpu_torch.utils
    from benchmark.harness import cell

    # the parent's program: no span module to import
    monkeypatch.delattr(rec_pangu_tpu_torch.utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "rec_pangu_tpu_torch.utils.trace", None)
    run = cell.Run(cell.Cell(bench(), name, OVERRIDES[name]), 1, "cpu", True)
    run.stats = {"count": 1}
    for metric in (HOST[name],) + DEVICE[name]:
        assert cell.load_module("metrics", metric).read(run) is None


class _Run:
    stats = {"count": 4}


@pytest.mark.parametrize("totals, want", [
    ({"batch.upload": {"calls": 4, "host_s": 0.010, "device_s": None},
      "batch.wait": {"calls": 4, "host_s": 0.006, "device_s": None}}, 1.0),
    ({"batch.upload": {"calls": 4, "host_s": 0.010, "device_s": None}}, None),
    ({"batch.upload": {"calls": 3, "host_s": 0.010, "device_s": None},
      "batch.wait": {"calls": 4, "host_s": 0.006, "device_s": None}}, None),
])
def test_the_host_batch_reading_leaves_out_the_wait(totals, want, monkeypatch):
    from benchmark.harness import spans
    from rec_pangu_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "totals", lambda: totals)
    got = spans.upload_host(_Run())
    assert got == pytest.approx(want) if want is not None else got is None


def test_a_device_reading_needs_the_spans_device_time(monkeypatch):
    from benchmark.harness import spans
    from rec_pangu_tpu_torch.utils import trace

    entry = {"calls": 8, "host_s": 0.001, "device_s": None}
    monkeypatch.setattr(trace, "totals", lambda: {"ce.product": entry})
    assert spans.per_call(_Run(), "ce.product", "device_s", per=2) is None
    entry["device_s"] = 0.012
    assert spans.per_call(_Run(), "ce.product", "device_s", per=2) == pytest.approx(3.0)
    assert spans.per_call(_Run(), "ce.product", "device_s") is None  # not once a call
