"""K1, the lookup kernel, in retrieval: K1's bytes (each distinct row
read once, each id's row written, the ids and offsets read; the ids of the
traced window's batches) over the bandwidth, over its device time."""
from benchmark.harness import readers


def read(run):
    return readers.roofline(run, readers.K1, moved=readers.k1_bytes(run))
