"""Mean wall time of an engine step that served requests, in ms: the sum of
the steps' walls over their count, from the engine's ``step_samples`` of the
window."""


def compute(record):
    if not record.steps:
        return None
    return 1e3 * sum(s[1] for s in record.steps) / len(record.steps)
