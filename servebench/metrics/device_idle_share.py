"""Share of the profiled sub-window in which no operation ran on the card."""


def compute(record):
    t = record.trace
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
