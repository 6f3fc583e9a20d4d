"""The traced run's instruments: host spans around the port's layers, and a
device profile of a fixed sub-window.

Spans are wrapped around the calls that ``spans.json`` lists, at run time,
from here: the port is not edited. Each records (name, start, end) on the
host clock (``time.time_ns``) into memory. The profiler (CUDA activity only,
so that it adds no per-op host cost; the card's activity is recorded
whichever thread launched it) is started and stopped by one helper thread of
the harness while it holds the service's lock, so each edge falls between two
engine steps. The profiler's timestamps are on the host clock (a kernel
launched right after a stamp starts some tens of microseconds after it), so
each edge is a host stamp taken after a synchronise. The sub-window's device
activity then gives busy time, kernel time by name, launches, and the idle
gaps, each labelled by the innermost host span open at its middle.
"""
from __future__ import annotations

import bisect
import importlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Optional

SPANS = Path(__file__).resolve().parent / "spans.json"
OUTSIDE = "service loop (no span)"
START_SETTLE_S = 0.1


def _resolve(target: str):
    """'pkg.mod:Class.method' -> (class, method name), or None."""
    mod_name, _, path = target.partition(":")
    try:
        obj = importlib.import_module(mod_name)
    except ImportError:
        return None
    *owners, attr = path.split(".")
    for name in owners:
        obj = getattr(obj, name, None)
        if obj is None:
            return None
    if not callable(getattr(obj, attr, None)):
        return None
    return obj, attr


def _kind(event, name: str) -> str:
    """'kernel', 'copy' (memcpy, memset) or 'annotation' of a device event:
    from its activity type where the profiler gives one (newer PyTorch),
    else from its name."""
    get = getattr(event, "activity_type", None)
    kind = str(get()) if get is not None else ""
    if "annotation" in kind:
        return "annotation"
    if "memcpy" in kind or "memset" in kind or \
            name.startswith(("Memcpy", "Memset")):
        return "copy"
    return "kernel"


class Tracer:
    """Spans plus the sub-window's device profile. ``start`` and ``stop``
    take the snapshot made at that edge (kept under ``edges``)."""

    def __init__(self, spans_file: Path = SPANS, profile_device: bool = True):
        self.entries = json.loads(Path(spans_file).read_text())["spans"]
        self.profile_device = profile_device
        self.spans: list = []
        self.edges: dict = {}
        self.marks: dict = {}
        self.state = "before"
        self._prof = None
        self._results = None
        self.stop_s = 0.0
        self._restore: list = []

    # -- spans ---------------------------------------------------------------
    def install(self):
        for entry in self.entries:
            found = _resolve(entry["target"])
            if found is None:
                print(f"span {entry['span']}: {entry['target']} not found, "
                      "skipped")
                continue
            owner, attr = found
            fn = getattr(owner, attr)
            self._restore.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(entry["span"], fn))

    def uninstall(self):
        for owner, attr, fn in reversed(self._restore):
            setattr(owner, attr, fn)
        self._restore = []

    def _wrap(self, name: str, fn):
        spans = self.spans

        def wrapper(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((name, t0, time.time_ns()))

        wrapper.__wrapped__ = fn
        return wrapper

    # -- the device profile ----------------------------------------------------
    def warm_up(self):
        """Start and stop the profiler once, so that its own set-up (CUPTI)
        is paid before the window."""
        if self.profile_device:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]):
                self._stamp("warm")

    def _stamp(self, key: str):
        """Synchronise, then stamp the host clock: all work launched before
        has ended by the stamp."""
        import torch
        torch.cuda.synchronize()
        self.marks[key] = time.time_ns()

    def start(self, snapshot):
        """Open the sub-window (between two engine steps)."""
        self.state = "on"
        self.edges["start"] = snapshot
        if self.profile_device:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            # the card's activity is recorded only some time after the
            # start: a kernel launched at once can be missing from the trace
            time.sleep(START_SETTLE_S)
            self._stamp("start")
        else:
            self.marks["start"] = time.time_ns()

    def stop(self, snapshot):
        """Close the sub-window (between two engine steps). The caller stops
        the profiler (``finish``) once it has let the engine go: the stop
        processes the sub-window's events."""
        self.state = "done"
        self.edges["end"] = snapshot
        if self._prof is None:
            self.marks["end"] = time.time_ns()
            return
        self._stamp("end")

    def finish(self):
        """Stop the profiler (in the thread that started it) and keep its
        raw events; the seconds it took are kept as ``stop_s``. The stop
        goes straight to the profiler's C++ end, without the Python parse of
        every event that ``profile.stop`` makes, which takes seconds and
        holds the interpreter (and so the engine) all the while."""
        if self._prof is not None and self._results is None:
            from torch.autograd.profiler import _disable_profiler
            t0 = time.time()
            self._results = _disable_profiler()
            self.stop_s = time.time() - t0

    # -- reading the profile ---------------------------------------------------
    def device_events(self) -> list:
        """(name, start_ns, end_ns, is_kernel) of every device activity that
        started between the two stamps, in start order. The profiler puts
        the card's activity on the host clock, and each stamp is taken after
        a synchronise with the engine held, so nothing runs across an edge."""
        if self._results is None or self.state != "done":
            return []
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        t0, t1 = self.marks["start"], self.marks["end"]
        out = []
        for e in self._results.events():
            if e.device_type() != cuda or not t0 <= e.start_ns() < t1:
                continue
            name = e.name()
            kind = _kind(e, name)
            if kind == "annotation":
                continue
            out.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                        kind == "kernel"))
        out.sort(key=lambda r: r[1])
        self.n_device_events = len(out)
        return out

    def summary(self, top: int = 10) -> Optional[dict]:
        """Busy and window seconds, kernel seconds by name, launches, and
        idle seconds by the host span open at each gap; None without a
        finished device profile."""
        body = self.device_events()
        if not body or not self.edges.get("end"):
            return None
        w0, w1 = self.marks["start"], self.marks["end"]
        busy, gaps, cursor = 0, [], w0
        for _, s, e, _ in body:
            s, e = max(s, w0), min(e, w1)
            if s > cursor:
                gaps.append((cursor, s))
            if e > cursor:
                busy += e - max(s, cursor)
                cursor = e
        if w1 > cursor:
            gaps.append((cursor, w1))
        by_name: dict = defaultdict(int)
        for name, s, e, _ in body:
            by_name[name] += e - s
        label_at = self._labeller()
        idle: dict = defaultdict(int)
        for s, e in gaps:
            idle[label_at((s + e) // 2)] += e - s
        return {
            "stop_s": self.stop_s,
            "window_s": (w1 - w0) / 1e9,
            "events": len(body),
            "busy_s": busy / 1e9,
            "kernel_s": {n: t / 1e9 for n, t in by_name.items()},
            "launches": sum(1 for r in body if r[3]),
            "device_ops": sorted(((n, t / 1e9) for n, t in by_name.items()),
                                 key=lambda r: -r[1])[:top],
            "idle_gaps": sorted(((n, t / 1e9) for n, t in idle.items()),
                                key=lambda r: -r[1])[:top],
        }

    def _labeller(self) -> Callable[[int], str]:
        """A map from a device time to the innermost host span open then:
        spans cut the timeline into segments, each labelled by the latest
        starting span that covers it."""
        lo, hi = self.marks["start"], self.marks["end"]
        spans = [(name, s, e) for name, s, e in self.spans
                 if e >= lo and s <= hi]
        cuts = sorted({t for _, s, e in spans for t in (s, e)})
        labels = []
        for a, b in zip(cuts[:-1], cuts[1:]):
            inside = [(s, name) for name, s, e in spans if s <= a and e >= b]
            labels.append(max(inside)[1] if inside else OUTSIDE)

        def label_at(t: int) -> str:
            i = bisect.bisect_right(cuts, t) - 1
            return labels[i] if 0 <= i < len(labels) else OUTSIDE
        return label_at
