"""The retrieval layer's ``select_ms.serve`` on the program's ``serve.select``
span: one device reading a request, and nothing where the span is missing,
comes twice a request, has no device time, or where the program has no
spans."""
import sys

import pytest

from benchmark.harness import cell
from benchmark.tests.tiny import OVERRIDES, bench

NAME = "sasrec_1m.retrieve"


class _Run:
    stats = {"count": 4}


def _read():
    return cell.load_module("metrics", "select_ms.serve").read(_Run())


@pytest.mark.parametrize("totals, want", [
    ({"serve.select": {"calls": 4, "host_s": 0.001, "device_s": 0.010}}, 2.5),
    ({"serve.score": {"calls": 4, "host_s": 0.001, "device_s": 0.010}}, None),
    ({"serve.select": {"calls": 8, "host_s": 0.001, "device_s": 0.010}}, None),
    ({"serve.select": {"calls": 4, "host_s": 0.001, "device_s": None}}, None),
])
def test_select_reads_the_span_once_a_request(totals, want, monkeypatch):
    from rec_pangu_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "totals", lambda: totals)
    got = _read()
    assert got == pytest.approx(want) if want is not None else got is None


def test_select_reads_nothing_without_the_programs_spans(monkeypatch):
    import rec_pangu_tpu_torch.utils

    monkeypatch.delattr(rec_pangu_tpu_torch.utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "rec_pangu_tpu_torch.utils.trace", None)
    run = cell.Run(cell.Cell(bench(), NAME, OVERRIDES[NAME]), 1, "cpu", True)
    run.stats = {"count": 1}
    assert cell.load_module("metrics", "select_ms.serve").read(run) is None
