"""The whole training step's share of the card's float32 peak: the model
FLOPs a step needs (``families/*.train_work``: forward and backward
products, attention, the full-corpus CE; nothing recomputed) times the
steps of the traced window, over its length, over the data-sheet rate."""
from benchmark.harness import readers


def read(run):
    return readers.mfu(run)
