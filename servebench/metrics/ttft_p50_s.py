"""Median time to first token over every request due in the window, from
its due time; a request without a first token counts as infinitely late
(open loop). The median is the highest percentile with ten requests beyond
it at the few tens of requests a window holds."""
from servebench import stats


def compute(record):
    due = stats.due_in_window(record)
    return stats.percentile([stats.ttft(r) for r in due], 50)
