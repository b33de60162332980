"""The retrieval layer's top-k: the device time of the program's
``serve.select`` span (``row_topk`` over the [B, V] scores; stream time
from its entry event to its exit event) a request.  None off the card,
where the program has no spans, or where the span did not come once a
request."""
from benchmark.harness import spans


def read(run):
    return spans.per_call(run, "serve.select", "device_s")
