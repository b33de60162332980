"""The program's spans (``rec_pangu_tpu_torch.utils.trace``) as per-layer
readings of the traced window."""
from __future__ import annotations

from typing import Optional


def per_call(run, name: str, field: str, per: int = 1) -> Optional[float]:
    """Span ``name``'s ``field`` (``host_s`` or ``device_s``) in ms a step
    or request of the traced window.  None where the program has no spans,
    where the span did not come ``per`` times a step or request, or where
    ``field`` was not recorded (device time off the card)."""
    try:
        from rec_pangu_tpu_torch.utils import trace
    except ImportError:
        return None
    span = trace.totals().get(name)
    count = run.stats["count"]
    if span is None or span["calls"] != per * count or span[field] is None:
        return None
    return span[field] * 1e3 / count


def upload_host(run) -> Optional[float]:
    """The host batch layer: ``batch.upload``'s host time less its
    ``batch.wait`` (the wait for the device's queued work), in ms a step or
    request."""
    upload = per_call(run, "batch.upload", "host_s")
    wait = per_call(run, "batch.wait", "host_s")
    return None if upload is None or wait is None else upload - wait
