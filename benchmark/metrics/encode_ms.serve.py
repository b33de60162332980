"""The encode stage of retrieval: the device time of the program's
``serve.encode`` span (the model's forward, K1, K4f and the pooling, and
the normalization) a request.  That is the stream time from its entry
event to its exit event, and the stream waits there on the host's launches
of the stage's small kernels, so under the profiler the reading follows the
host's launch rate more than the kernels' time (K4f's own share is
``k4f_roofline.serve``).  None off the card, where the program has no
spans, or where the span did not come once a request."""
from benchmark.harness import spans


def read(run):
    return spans.per_call(run, "serve.encode", "device_s")
