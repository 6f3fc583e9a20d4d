"""Seconds from the process's start to the opening of the window: imports,
kernel loading (and building, on a checkout's first run), the weights, the
service and the warm-up."""


def compute(record):
    return record.setup_s
