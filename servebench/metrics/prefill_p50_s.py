"""Median prefill time: first token minus (last) admission, over requests
due in the window that got their first token."""
from servebench import stats


def compute(record):
    return stats.median([r["first"] - r["admit"]
                         for r in stats.due_in_window(record)
                         if r["first"] >= 0 and r["admit"] >= 0])
