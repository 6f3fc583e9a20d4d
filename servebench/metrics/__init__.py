"""One reader per metric, found by name: ``<name>.py`` defines
``compute(record) -> float | None`` over a run's ``harness.Record``. A reader
that finds nothing to read returns None, and the run leaves the metric out."""
