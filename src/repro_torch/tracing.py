"""Spans and token stamps recorded inside the port, for a traced run.

One process-wide recorder, off by default and switched by ``enable()`` and
``disable()``. Off, ``span`` returns one shared no-op object after one
attribute test (no allocation, no clock read) and ``token`` returns at once.

On, a span records its name, its start and end on the host clock
(``time.time_ns``: the clock of the benchmark's host stamps and of the
profiler's device events), the index of the span open around it in the same
thread, the real tokens its block computes where it computes any
(``tokens``), and what ``annotate`` adds inside it. A span opened with
``device=True`` also records a pair of CUDA events on the current stream.
They are read only by ``export``, so the hot path never waits for the card,
and there the span ends at the later of its host end and the completion of
the work it launched; on the CPU the work is done by the host end.
``token(rid)`` stamps one produced token of request ``rid``.

The engine thread and the admin (fault) thread both record: a lock orders
the appends, and each thread nests its own spans.

    tracing.reset(); tracing.enable()
    ...                               # serve
    tracing.disable(); data = tracing.export()
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import torch

CLOCK = time.time_ns

# a span's record: [name, start, end, parent, attrs, start event,
# end event]; end is 0 while the span is open
_NAME, _START, _END, _PARENT, _ATTRS, _EV0, _EV1 = range(7)


class _Recorder:
    def __init__(self):
        self.on = False
        self.lock = threading.Lock()
        self.local = threading.local()
        self.spans: list = []
        self.tokens: list = []
        # (CUDA event, host ns at its record after a synchronise): maps a
        # device event onto the host clock
        self.anchor: Optional[tuple] = None

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


REC = _Recorder()


class _Noop:
    """What ``span`` returns while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP = _Noop()


def _anchor():
    """An event recorded on an idle card and the host time it ran at."""
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    t = CLOCK()
    ev.synchronize()
    return ev, t


class _Span:
    __slots__ = ("rec", "device")

    def __init__(self, name, device, attrs):
        self.rec = [name, 0, 0, -1, attrs, None, None]
        self.device = device

    def __enter__(self):
        rec, stack = self.rec, REC.stack()
        rec[_PARENT] = stack[-1] if stack else -1
        with REC.lock:
            idx = len(REC.spans)
            REC.spans.append(rec)
            if self.device and REC.anchor is None:
                REC.anchor = _anchor()
        stack.append(idx)
        rec[_START] = CLOCK()
        if self.device:
            rec[_EV0] = torch.cuda.Event(enable_timing=True)
            rec[_EV0].record()
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        if self.device:
            rec[_EV1] = torch.cuda.Event(enable_timing=True)
            rec[_EV1].record()
        rec[_END] = CLOCK()
        REC.stack().pop()
        return False


def span(name: str, device: bool = False, tokens: Optional[int] = None):
    """A context manager timing the block it encloses. ``device``: the
    block launches work on a CUDA card (true only there), timed to its
    completion; ``tokens``: the real tokens the block computes."""
    if not REC.on:
        return NOOP
    return _Span(name, device,
                 {} if tokens is None else {"tokens": int(tokens)})


def annotate(**attrs):
    """Add ``attrs`` to the innermost span open in this thread (nothing
    while off or outside any span). A tensor value is kept as it is, on its
    device, and read only by ``export``, which gives it as a list."""
    if REC.on:
        stack = REC.stack()
        if stack:
            REC.spans[stack[-1]][_ATTRS].update(attrs)


def token(rid: int):
    """Stamp one token of request ``rid``, produced now."""
    if REC.on:
        with REC.lock:
            REC.tokens.append((rid, CLOCK()))


def enable():
    """Start recording (the records made so far are kept)."""
    with REC.lock:
        if torch.cuda.is_available() and torch.cuda.is_initialized() \
                and REC.anchor is None:
            REC.anchor = _anchor()
        REC.on = True


def disable():
    REC.on = False


def enabled() -> bool:
    return REC.on


def reset():
    """Drop every record (while off)."""
    with REC.lock:
        REC.spans, REC.tokens, REC.anchor = [], [], None


def _device_times(rec, anchor) -> tuple:
    """(start, end) of a device span's events on the host clock: the start
    placed from the anchor, the end from the span's own events (short
    intervals keep the events' resolution)."""
    ev, t = anchor
    start = t + round(ev.elapsed_time(rec[_EV0]) * 1e6)
    return start, start + round(rec[_EV0].elapsed_time(rec[_EV1]) * 1e6)


def export() -> dict:
    """Every finished span and token stamp as plain data:
    ``{"spans": [...], "tokens": [(rid, ns), ...]}``. A span is a dict with
    ``name``, ``start``, ``end``, ``host_end`` (ns), ``parent`` (index in
    the list, -1 at the top) and ``attrs``; one timed on the card
    also has ``device_start`` and ``device_end``, and its ``end`` is the
    later of its host end and its device end. An unfinished span is
    exported with ``end`` -1 (its children keep their parent index). Waits
    for the card once when a span was timed there."""
    with REC.lock:
        spans, tokens, anchor = list(REC.spans), list(REC.tokens), REC.anchor
    if anchor is not None and any(r[_EV1] is not None for r in spans):
        torch.cuda.synchronize()
    out = []
    for rec in spans:
        done = rec[_END] > 0
        d = {"name": rec[_NAME], "start": rec[_START],
             "end": rec[_END] if done else -1,
             "host_end": rec[_END] if done else -1,
             "parent": rec[_PARENT],
             "attrs": {k: v.tolist() if isinstance(v, torch.Tensor) else v
                       for k, v in rec[_ATTRS].items()}}
        if done and rec[_EV1] is not None and anchor is not None:
            d["device_start"], d["device_end"] = _device_times(rec, anchor)
            d["end"] = max(d["end"], d["device_end"])
        out.append(d)
    return {"spans": out, "tokens": tokens}
