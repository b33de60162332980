"""The scoring layer in retrieval: the device time of the program's
``serve.score`` span (``score_items``, the [B, V] product; stream time
from its entry event to its exit event) a request.  None off the card,
where the program has no spans, or where the span did not come once a
request."""
from benchmark.harness import spans


def read(run):
    return spans.per_call(run, "serve.score", "device_s")
