"""Prefill time per prompt token, in us: the port's ``prefill.chunk`` spans
that started in the window, each from its start to the completion of its
work on the card (host end on the CPU), summed, over the real tokens they
computed (padding to the chunk is not counted)."""
from servebench import program


def compute(record):
    found = program.spans(record, "prefill.chunk")
    tokens = sum(s["attrs"].get("tokens", 0) for s in found)
    if not tokens:
        return None
    return sum(s["end"] - s["start"] for s in found) / tokens / 1e3
