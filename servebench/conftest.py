import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (a CUDA kernel has no CPU mode) — skips "
        "without one; run on the card with `python -m pytest -m gpu`")
