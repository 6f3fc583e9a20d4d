"""Kernel launches in the profiled sub-window per engine step that served
requests in it (the growth of the engine's ``step_samples``)."""


def compute(record):
    t = record.trace
    if not t:
        return None
    steps = t["edges"]["end"]["steps"] - t["edges"]["start"]["steps"]
    return t["launches"] / steps if steps > 0 else None
