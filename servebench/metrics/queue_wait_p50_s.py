"""Median admission wait: the last admission's time minus the due time, over
requests due in the window that were admitted (service loop and engine)."""
from servebench import stats


def compute(record):
    return stats.median([r["admit"] - r["due"]
                         for r in stats.due_in_window(record)
                         if r["admit"] >= 0])
