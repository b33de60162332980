"""The host batch layer: ``upload_batch`` (the id check and the copy) and a
synchronize, per batch, averaged over the cell's pool, timed apart from the
window (``modes/train.after_trace``)."""


def read(run):
    return None if run.upload_s is None else run.upload_s * 1e3
