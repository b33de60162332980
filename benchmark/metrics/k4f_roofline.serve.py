"""K4f, the fused encoder forward, in retrieval: ``encoder_work``'s FLOP over
the float32 peak, over its device time."""
from benchmark.harness import readers


def read(run):
    return readers.roofline(run, readers.K4F, flop=run.work["k4f_flop"])
