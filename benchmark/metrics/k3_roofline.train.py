"""K3, the fused table Adam, in training: its bytes (the table and both
moments read and written, since Adam moves every row; the CE's dense
stream where the step has one; the cotangent rows and ids read) over the
bandwidth, over the device time of its three kernels (run sums, tile
starts, the tile update), the sort left out."""
from benchmark.harness import readers


def read(run):
    return readers.roofline(run, readers.K3, moved=run.work["k3_bytes"])
