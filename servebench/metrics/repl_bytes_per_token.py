"""Replicated KV bytes that landed on ring peers inside the window
(``replication_stats()["bytes_total"]`` at the close minus at the open) per
output token produced inside the window."""
from servebench import stats


def compute(record):
    tokens = stats.tokens_in_window(record)
    return record.repl_bytes / tokens if tokens else None
