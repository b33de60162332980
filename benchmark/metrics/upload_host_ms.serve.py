"""The host batch layer in retrieval, inside the traced window: the host
time of the program's ``batch.upload`` span (``upload_batch``'s id check
and host-to-device copies) a request, less its ``batch.wait`` (the wait
for the device's queued work).  None where the program has no such spans
or they did not come once a request."""
from benchmark.harness import spans


def read(run):
    return spans.upload_host(run)
