"""Seed 2 of the reference's failure storm on the port's ``ServingSystem``
(seeds 0 and 1, and the body of the check, are in
test_torch_failure_storm.py). A file of its own, because each storm is
26,000 steps of the simulation."""
import pytest

pytest.importorskip("torch")

from test_torch_failure_storm import check_storm  # noqa: E402


@pytest.mark.parametrize("seed", [2])
def test_failure_storm_recovers(seed):
    check_storm(seed)
