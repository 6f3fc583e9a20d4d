"""The port's ``ServingSystem`` against the reference's in lockstep
(``torch_sim_lockstep.py``) through harder faults: donor exhaustion, a
donor cascade, the failure storm shortened to 600 sim seconds, and KV
pressure."""
import pytest

pytest.importorskip("torch")

from repro.core import system as JS  # noqa: E402
from torch_sim_lockstep import lockstep  # noqa: E402


def test_lockstep_donor_exhaustion_equals_reference():
    """Stage 2 of both instances dies (tests/test_failure_storm.py): no
    donor exists, so both instances take the standard path, go offline for
    the full init and come back."""
    _, st = lockstep(2, "kevlarflow", 1.0, 300.0, 800.0,
                     [(60.0, 2), (60.0, 6)])
    assert st.recovery.stats["reforms"] == 0
    assert st.recovery.stats["restarts"] > 0
    assert all(i.is_serving() for i in st.group.instances)
    assert [e.replaced_at > 0 for e in st.mttr_events()] == [True, True]


def test_lockstep_donor_cascade_equals_reference():
    """(0, 1) dies and its ring target (1, 1), node 5, donates; then the
    donor dies too (tests/test_cluster.py), and both instances re-form on
    (2, 1)."""
    _, st = lockstep(3, "kevlarflow", 1.5, 200.0, 700.0,
                     [(30.0, 1), (90.0, 5)])
    assert st.recovery.stats["reforms"] == 3
    assert [e.node_id for e in st.mttr_events()] == [1, 5]
    assert all(e.replaced_at > 0 for e in st.mttr_events())


def test_lockstep_storm_equals_reference():
    """The storm, shortened: seed 0, 4 instances, 3 failures on random
    healthy nodes between 120 and 500 s, drawn as the storm draws them,
    over 600 sim seconds."""
    _, st = lockstep(4, "kevlarflow", 3.0, 500.0, 600.0, seed=0,
                     storm=(0, 3, (120.0, 500.0)))
    assert len(st.injector.events) == 3
    assert st.recovery.stats["reforms"] >= 3


def _stage_order(nodes):
    return list(dict.fromkeys(nodes))


def test_lockstep_under_kv_pressure_equals_reference_in_stage_order(
        monkeypatch):
    """Under KV pressure ``_kv_on_prefill`` can stop at a node that cannot
    allocate, after earlier nodes evicted replicas: the state then depends
    on the order the stage nodes are visited in. The reference visits
    ``set(stage_nodes)``, in object-hash order; the port visits them in
    stage order. With the reference's visits put in stage order too, the
    two agree at every step."""
    monkeypatch.setattr(JS, "set", _stage_order, raising=False)
    _, st = lockstep(2, "kevlarflow", 2.0, 200.0, 300.0, [(60.0, 1)],
                     kv_blocks_per_node=1024)
    assert st.replication.stats["hosted_rejected"] > 0
    assert st.metrics()["n"] > 0
