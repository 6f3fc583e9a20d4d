"""Output tokens produced inside the window over the window's length (the
sum of ``generated`` at the close minus at the open). Also read for
``output_tok_s.open``, the open-loop cells' own: there the offered load
pins it, and it falls when the service falls behind the schedule or drops
work."""
from servebench import stats


def compute(record):
    return stats.tokens_in_window(record) / (record.t_close - record.t_open)
