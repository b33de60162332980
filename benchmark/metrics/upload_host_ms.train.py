"""The host batch layer in training, inside the traced window: the host
time of the program's ``batch.upload`` span (``upload_batch``'s id check
and host-to-device copies) a step, less its ``batch.wait`` (the wait for
the previous step's device work).  None where the program has no such
spans or they did not come once a step."""
from benchmark.harness import spans


def read(run):
    return spans.upload_host(run)
