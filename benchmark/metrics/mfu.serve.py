"""The whole retrieval request's share of the card's float32 peak: the
model FLOPs a request needs (``families/*.request_work``: the encoder's
products and the scoring product over the corpus) times the requests of
the traced window, over its length, over the data-sheet rate."""
from benchmark.harness import readers


def read(run):
    return readers.mfu(run)
