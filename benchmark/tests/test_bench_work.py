"""The frozen work counts and peaks give PERF.md's figures at bench.py's
shapes (16 fields x 100,001 rows at D = 32 and 8,192 rows; SASRec's 1,024
histories of 50 at D = 64, inner 32, two layers, 1,000,000 items)."""
import pytest

from benchmark.harness import work

BENCH_ROWS = 1_605_632        # padded_rows(16 * 100,001)
SEQ_ROWS = 1_007_616          # padded_rows(1,000,000)


def test_lookup_bytes():
    assert work.lookup_bytes(8192 * 16, 32, 16) == 34_078_784


def test_adam_bytes():
    assert work.adam_bytes(BENCH_ROWS, 32, 8192 * 16) == 1_250_426_880
    assert work.adam_bytes(SEQ_ROWS, 64, 1024 * 50, dense=True) == 1_818_959_872
    assert work.adam_bytes(SEQ_ROWS, 64, 1024 * 50, dense=True, moment_bytes=2) == 1_303_060_480


def test_encoder_work():
    assert work.encoder_work(1024, 50, 64, 32, 2)[0] == 5_505_024_000
    assert work.encoder_bwd_work(1024, 50, 64, 32, 2)[0] == 11_665_408_000


@pytest.mark.parametrize("name,bw,fp32,tf32", [
    ("NVIDIA H100 80GB HBM3", 3.35e12, 67e12, 495e12),
    ("NVIDIA H100 PCIe", 2.0e12, 51e12, 378e12),
    ("NVIDIA H100 NVL", 3.9e12, 60e12, 417.5e12),
])
def test_peaks(name, bw, fp32, tf32):
    assert work.peak(work.BANDWIDTH, name) == bw
    assert work.peak(work.FP32_PEAK, name) == fp32
    assert work.peak(work.TF32_PEAK, name) == tf32


def test_unknown_card_raises():
    with pytest.raises(ValueError):
        work.peak(work.BANDWIDTH, "cpu")
