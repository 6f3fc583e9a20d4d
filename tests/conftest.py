import os
import sys

import pytest

# Tests run on the REAL device count (1 CPU device). Only launch/dryrun.py
# sets the 512-device flag, per the assignment.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (chaos drills, deep hypothesis sweeps)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running chaos / deep property suites — excluded from "
        "tier-1 by default; run with --runslow (CI runs them as a separate "
        "non-blocking job)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (a CUDA kernel has no CPU mode) — skips "
        "without one; run on the card with `python -m pytest -m gpu`")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
