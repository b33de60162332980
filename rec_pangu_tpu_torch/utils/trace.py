"""Spans at the port's layer boundaries, read from ``torch.profiler``.

``span(name)`` marks one stretch of the program.  With no profiler
recording it returns one shared no-op context (``OFF``): it allocates
nothing, records nothing and calls nothing into CUDA, so a span costs one
flag test (``torch.autograd.profiler._is_profiler_enabled``, the flag the
profiler sets while it records).

While a profiler records, every span enters
``torch.profiler.record_function(name, id)``: its host interval lies in the
profiler's own trace (``fit(profile_dir=)``'s Chrome trace among it), on
the clock of the device events.  ``id`` is the running number of the open
top-level span, a step or a request (``span(name, top=n, device=d)``), on
whatever thread the span opens: the CE's backward runs on the autograd
engine's device thread.

The spans a per-layer metric reads also go into an in-memory store keyed by
name: each adds its calls and host seconds, and a span in ``DEVICE``
records, on the card, a timing ``torch.cuda.Event`` on the current stream
at entry and at exit.  Its device time is the stream time from the one to
the other: the kernels it launched and any gap of the stream between them.
``totals()`` returns ``{"calls", "host_s", "device_s"}`` by name
(``device_s`` None off the card).  The other spans are a bare
``record_function``.

When a top-level span opens, the event pairs the stream has reached are
folded into their totals and their events kept for reuse, so a traced
window makes no new objects that outlive a step: objects that pile up bring
the garbage collector's full pass (200-450 ms in a process that has loaded
torch) into the window.  The store holds no tensors.  It holds what the
latest profiler session recorded: ``reset()`` empties it, and the first
top-level span recorded after ``totals()`` was read starts it anew.

The spans (* in the store; ** with device time too):

==================  =========================================================
``train.step``      top level: one training step (``_BaseTrainer._step_on``),
                    id the trainer's step counter
``batch.upload`` *  ``upload_batch``: the id check, the wait and the
                    host-to-device copies
``batch.check``     inside it, the host id check
``batch.wait`` *    inside it, the wait for the device's queued work that a
                    copy from pageable memory makes
``step.forward``    the fused steps' model call
``step.backward``   the fused steps' ``torch.autograd.grad``
``ce.forward`` **   the streamed CE's chunked logsumexp and positive logits
``ce.backward`` **  its recomputed softmax and gradient products
``ce.product`` **   each chunk product of the CE: four a chunk a step
``table.update``    the fused steps' table update: the ids, the sort and K3
``table.sort``      inside it, the ids' sort (``fused_adam.sort_for``)
``serve.request``   top level: one scorer request, id the scorer's count
``serve.encode`` ** retrieval's model forward and normalization
``serve.score`` **  retrieval's [B, V] scoring product
``serve.select`` ** retrieval's top-k of the scores (``row_topk``)
==================  =========================================================

No span lies inside a model's ``forward`` or an op ``serving/export.py``
traces.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

HOST = frozenset({"batch.upload", "batch.wait"})
DEVICE = frozenset({"ce.forward", "ce.backward", "ce.product", "serve.encode", "serve.score",
                    "serve.select"})


class _Off:
    """The shared context of a span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Entry:
    __slots__ = ("calls", "host_s", "device_s")

    def __init__(self):
        self.calls, self.host_s, self.device_s = 0, 0.0, None


class _Store:
    """The stored spans of the latest profiler session, by name."""

    def __init__(self):
        self.lock = threading.Lock()
        self.entries: Dict[str, _Entry] = {}
        self.pending: List[tuple] = []  # (entry, start event, end event), in recording order
        self.free: List[torch.cuda.Event] = []  # folded events, for reuse
        self.top: tuple = (None, None)  # (id, device) of the open top-level span
        self.read = False  # totals() was read since the last span was recorded

    def clear(self) -> None:
        self.entries, self.pending, self.read = {}, [], False

    def event(self) -> torch.cuda.Event:
        try:
            return self.free.pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def fold(self, wait: bool) -> None:
        """Add the device time of the pending pairs up to the first whose end
        the stream has not reached (every pair, waiting for it, when
        ``wait``)."""
        with self.lock:
            done = 0
            for entry, start, end in self.pending:
                if wait:
                    end.synchronize()
                elif not end.query():
                    break
                entry.device_s += start.elapsed_time(end) / 1e3
                self.free += (start, end)
                done += 1
            del self.pending[:done]

    def add(self, name: str, host_s: float, pair) -> None:
        with self.lock:
            entry = self.entries.get(name)
            if entry is None:
                entry = self.entries[name] = _Entry()
            entry.calls += 1
            entry.host_s += host_s
            if pair is not None:
                entry.device_s = entry.device_s or 0.0
                self.pending.append((entry, *pair))


_STORE = _Store()


class _Top:
    __slots__ = ("rf", "ident", "device")

    def __init__(self, name: str, ident: int, device):
        self.rf = torch.profiler.record_function(name, str(ident))
        self.ident, self.device = ident, None if device is None else torch.device(device)

    def __enter__(self):
        store = _STORE
        if store.read:
            store.clear()
        store.fold(wait=False)
        store.top = (self.ident, self.device)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        _STORE.top = (None, None)
        return False


class _Stored:
    __slots__ = ("name", "rf", "device", "start", "t0")

    def __init__(self, name: str, rf, device):
        self.name, self.rf = name, rf
        timed = name in DEVICE and device is not None and device.type == "cuda"
        self.device = device if timed else None

    def __enter__(self):
        self.rf.__enter__()
        self.start = None
        if self.device is not None:
            self.start = _STORE.event()
            self.start.record(torch.cuda.current_stream(self.device))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        pair = None
        if self.start is not None:
            end = _STORE.event()
            end.record(torch.cuda.current_stream(self.device))
            pair = (self.start, end)
        self.rf.__exit__(*exc)
        _STORE.add(self.name, host_s, pair)
        return False


def span(name: str, top: Optional[int] = None, device=None):
    """The context of span ``name``: ``OFF`` while no profiler records.  A
    top-level span gives its running number ``top`` and the ``device`` its
    work runs on; a span inside one takes both from it."""
    if not _profiler._is_profiler_enabled:
        return OFF
    if top is not None:
        return _Top(name, top, device)
    ident, dev = _STORE.top
    rf = torch.profiler.record_function(name, None if ident is None else str(ident))
    if name in HOST or name in DEVICE:
        return _Stored(name, rf, dev)
    return rf


def totals() -> Dict[str, dict]:
    """For each stored span recorded: ``calls``, ``host_s`` and
    ``device_s`` (None where no event pair was recorded).  Waits for the
    pending event pairs."""
    _STORE.fold(wait=True)
    with _STORE.lock:
        _STORE.read = True
        return {name: {"calls": e.calls, "host_s": e.host_s, "device_s": e.device_s}
                for name, e in _STORE.entries.items()}


def reset() -> None:
    """Empty the store."""
    _STORE.fold(wait=True)
    with _STORE.lock:
        _STORE.clear()
