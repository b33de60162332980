"""The retrieval layer's top-k: device time of the kernels that
``torch.topk`` launched, per request of the traced window."""


def read(run):
    seconds = run.trace.op_seconds("aten::topk")
    return seconds * 1e3 / run.stats["count"] if seconds > 0 else None
