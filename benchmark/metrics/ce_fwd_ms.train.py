"""The loss layer's forward: the device time of the program's
``ce.forward`` span (the streamed CE's chunked logsumexp and positive
logits; stream time from its entry event to its exit event) a step.  None
off the card, where the program has no spans, or where the span did not
come once a step."""
from benchmark.harness import spans


def read(run):
    return spans.per_call(run, "ce.forward", "device_s")
