"""K4b, the fused encoder backward, in training: ``encoder_bwd_work``'s FLOP
over the float32 peak, over the device time of its launches (the weight
transposes, rows, attention, weight gradients and their sum)."""
from benchmark.harness import readers


def read(run):
    return readers.roofline(run, readers.K4B, flop=run.work["k4b_flop"])
