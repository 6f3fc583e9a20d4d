"""The port's own spans and token stamps in a traced run, for the metrics
that read them.

The port records spans at its work sites and a stamp per produced token
(``repro_torch.tracing``), off unless switched on. Loading this module (the
readers that use it import it) joins that recorder to the traced run's
``trace.Tracer``: from ``Tracer.install``, just before the window opens, to
``Tracer.uninstall``, after the service has stopped, the recorder is on.
Its export is then kept here, and its spans are added to the tracer's, so
that the breakdown puts each idle gap of the card down to the innermost
span open then, the port's own included. Untraced runs never install a
tracer, so there the recorder stays off. A port without the recorder leaves
the tracer as it was, and the readers find nothing and return None.
"""
from __future__ import annotations

import sys
from typing import List, Optional

from servebench.trace import Tracer

LAST: Optional[dict] = None     # the export of this process's last traced run


def _join_tracer():
    try:
        from repro_torch import tracing
    except ImportError:
        return                  # a port without the recorder
    install, uninstall = Tracer.install, Tracer.uninstall

    def install_with_recorder(self):
        global LAST
        LAST = None
        tracing.reset()
        tracing.enable()
        install(self)

    def uninstall_with_recorder(self):
        global LAST
        uninstall(self)
        if not tracing.enabled():
            return
        tracing.disable()
        try:
            LAST = tracing.export()
        except Exception as e:  # noqa: BLE001 — the run goes on without it
            print(f"servebench: the port's spans were not read: {e!r}",
                  file=sys.stderr)
            return
        self.spans.extend((s["name"], s["start"], s["host_end"])
                          for s in LAST["spans"] if s["host_end"] >= 0)

    Tracer.install = install_with_recorder
    Tracer.uninstall = uninstall_with_recorder


_join_tracer()


def all_spans(record) -> List[dict]:
    return LAST["spans"] if LAST else []


def spans(record, name: str, until_stop: bool = False) -> List[dict]:
    """The finished spans called ``name`` that started inside the window
    (``until_stop``: from its open until the service stopped, so that a
    warm-spare rejoin falling in the grace after the close counts)."""
    lo = record.t_open * 1e9
    hi = (record.t_stop if until_stop else record.t_close) * 1e9
    return [s for s in all_spans(record)
            if s["name"] == name and s["end"] >= 0 and lo <= s["start"] < hi]


def tokens(record) -> List[tuple]:
    """(rid, ns) of every token stamped inside the window."""
    if not LAST:
        return []
    lo, hi = record.t_open * 1e9, record.t_close * 1e9
    return [(rid, t) for rid, t in LAST["tokens"] if lo <= t <= hi]


def mean_ms(found: List[dict]) -> Optional[float]:
    """Mean duration of the spans, in ms; None without any."""
    if not found:
        return None
    return sum(s["end"] - s["start"] for s in found) / len(found) / 1e6


def enclosing_attr(all_: List[dict], span: dict, key: str) -> Optional[int]:
    """The attribute ``key`` of the nearest span around ``span`` (itself
    first) that has it."""
    while span is not None:
        if key in span["attrs"]:
            return span["attrs"][key]
        span = all_[span["parent"]] if span["parent"] >= 0 else None
    return None
