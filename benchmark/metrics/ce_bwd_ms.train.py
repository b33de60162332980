"""The loss layer's backward: the device time of the program's
``ce.backward`` span (the streamed CE's recomputed softmax and gradient
products, on the autograd engine's thread; stream time from its entry
event to its exit event) a step.  None off the card, where the program has
no spans, or where the span did not come once a step."""
from benchmark.harness import spans


def read(run):
    return spans.per_call(run, "ce.backward", "device_s")
