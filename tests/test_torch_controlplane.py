"""The port's control plane (``serving/controlplane.py``) against the
reference's: over seeded sequences of kills, rejoins, shard losses and
restores on 8-16 instance fleets, both packages give the same epochs, the
same successor and rendezvous targets (degraded members included), the
same routing order, the same planner order and ``pending_kind``, and the
same ``describe()`` dicts. With hypothesis installed, the reference's
membership machine also runs on both packages in lockstep."""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

try:
    from hypothesis import settings, strategies as st
    from hypothesis.stateful import RuleBasedStateMachine, invariant, rule
    HAVE_HYPOTHESIS = True
except ImportError:                     # the seeded sweep still runs
    HAVE_HYPOTHESIS = False

from repro.serving import controlplane as J  # noqa: E402
from repro_torch.serving import controlplane as T  # noqa: E402

PLACEMENTS = ("successor", "rendezvous")


def _pair(n, placement="successor"):
    roles = {i: ("prefill" if i < n // 2 else "decode") for i in range(n)}
    return (J.ControlPlane(n, placement=placement, roles=roles,
                           degraded_load_penalty=2.0),
            T.ControlPlane(n, placement=placement, roles=roles,
                           degraded_load_penalty=2.0))


def _observe(cp, mod, loads):
    """Everything a consumer reads off a control plane (``mod`` is the
    package's controlplane module)."""
    view = cp.view
    cands = [SimpleNamespace(instance_id=i) for i in view.alive_ids()]
    load = lambda c: loads[c.instance_id]  # noqa: E731
    out = {
        "describe": cp.describe(),
        "targets": {name: mod.make_placement(name).targets(view)
                    for name in PLACEMENTS},
        "states": [view.state_of(i) for i in range(view.n)],
        "kinds": [cp.planner.pending_kind(i) for i in range(view.n)],
        "pending": cp.planner.pending_rejoins(),
        "has_pending": cp.planner.has_pending(),
        "order": [c.instance_id for c in cp.routing.order(cands, load)],
        "pick": cp.routing.pick(cands, load).instance_id if cands else None,
    }
    return out


def _apply(cp, op, t):
    """One membership event, the way the engine drives the control
    plane. Returns what the calls returned."""
    kind, iid, arg = op
    view, planner = cp.view, cp.planner
    if kind == "kill":
        changed = view.mark_failed(iid)
        if changed:
            planner.on_failure(iid, t, rejoin_at=None if arg < 0 else t + arg,
                               kind="instance")
        return changed
    if kind == "degrade":
        if not view.is_alive(iid):
            return None
        changed = view.mark_degraded(iid, int(arg))
        if changed:
            planner.on_failure(iid, t, rejoin_at=t + 2.0, kind="shard")
        return changed
    if kind == "restore":
        changed = view.mark_restored(iid)
        planner.on_rejoined(iid, t)
        return changed
    if kind == "rejoin":
        changed = view.mark_alive(iid)
        planner.on_rejoined(iid, t)
        return changed
    due = planner.next_due(t)            # "tick": serve the plan
    if due is not None:
        if planner.pending_kind(due) == "shard":
            view.mark_restored(due)
        else:
            view.mark_alive(due)
        planner.on_rejoined(due, t)
    return due


def _ops(rng, n, steps):
    kinds = ["kill", "degrade", "restore", "rejoin", "tick", "tick"]
    for _ in range(steps):
        kind = kinds[int(rng.integers(len(kinds)))]
        iid = int(rng.integers(n))
        if kind == "kill":
            arg = float(rng.choice([-1.0, 1.0, 3.0, 5.0]))
        else:
            arg = float(rng.integers(4))
        yield kind, iid, arg


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("seed", range(6))
def test_control_planes_agree_over_seeded_membership_sweep(placement, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 17))
    jcp, tcp = _pair(n, placement)
    t = 0.0
    for op in _ops(rng, n, 120):
        t += 1.0
        assert _apply(jcp, op, t) == _apply(tcp, op, t), op
        loads = {i: int(rng.integers(0, 6)) for i in range(n)}
        assert _observe(tcp, T, loads) == _observe(jcp, J, loads), op
        assert tcp.view.epoch == jcp.view.epoch
        assert tcp.planner.plan(tcp.placement) == \
            jcp.planner.plan(jcp.placement)


@pytest.mark.parametrize("n", [8, 12, 16])
def test_placement_targets_agree_on_random_alive_sets(n):
    """Every alive set (with some members degraded) gives the same target
    for every source under both policies."""
    rng = np.random.default_rng(n)
    for _ in range(60):
        jview, tview = J.ClusterView(n), T.ClusterView(n)
        for iid in range(n):
            r = rng.random()
            if r < 0.3:
                jview.mark_failed(iid)
                tview.mark_failed(iid)
            elif r < 0.5:
                jview.mark_degraded(iid, int(rng.integers(4)))
                tview.mark_degraded(iid, int(rng.integers(4)))
        assert tview.snapshot()["alive"] == jview.snapshot()["alive"]
        for name in PLACEMENTS:
            jp, tp = J.make_placement(name), T.make_placement(name)
            for src in range(n):
                assert tp.target(src, tview) == jp.target(src, jview)


if HAVE_HYPOTHESIS:
    class LockstepMembershipMachine(RuleBasedStateMachine):
        """The reference's membership machine (random kill / rejoin
        sequences on a 10-instance view with a planner riding along),
        driven on both packages at once: after every rule both must agree,
        and the reference's placement invariants hold on the port."""

        def __init__(self):
            super().__init__()
            self.planes = [(J.ClusterView(10), J), (T.ClusterView(10), T)]
            self.planners = [mod.RecoveryPlanner(v) for v, mod in self.planes]
            self.policies = [(J.SuccessorPlacement(), T.SuccessorPlacement()),
                             (J.RendezvousPlacement(),
                              T.RendezvousPlacement())]
            self.changes = 0
            self.t = 0.0

        @rule(iid=st.integers(0, 9), delay=st.floats(0.5, 5.0))
        def kill(self, iid, delay):
            self.t += 1.0
            changed = [v.mark_failed(iid) for v, _ in self.planes]
            assert changed[0] == changed[1]
            if changed[0]:
                self.changes += 1
                for p in self.planners:
                    p.on_failure(iid, self.t, rejoin_at=self.t + delay)

        @rule()
        def tick_rejoin(self):
            self.t += 1.0
            dues = [p.next_due(self.t) for p in self.planners]
            assert dues[0] == dues[1]
            if dues[0] is not None:
                changed = []
                for (v, _), p in zip(self.planes, self.planners):
                    p.on_rejoined(dues[0], self.t)
                    changed.append(v.mark_alive(dues[0]))
                assert changed[0] == changed[1]
                if changed[0]:
                    self.changes += 1

        @invariant()
        def agree(self):
            (jv, _), (tv, _) = self.planes
            assert tv.snapshot() == jv.snapshot()
            assert self.planners[1].pending_rejoins() == \
                self.planners[0].pending_rejoins()
            for jp, tp in self.policies:
                assert tp.targets(tv) == jp.targets(jv)

        @invariant()
        def epoch_counts_changes(self):
            assert self.planes[1][0].epoch == self.changes

        @invariant()
        def placement_valid(self):
            view = self.planes[1][0]
            for _, pol in self.policies:
                for i in view.alive_ids():
                    tgt = pol.target(i, view)
                    if view.n_alive() < 2:
                        assert tgt == -1
                    else:
                        assert tgt != i and view.is_alive(tgt)

        @invariant()
        def pending_are_dead(self):
            view = self.planes[1][0]
            for iid, _ in self.planners[1].pending_rejoins():
                assert not view.is_alive(iid)

    LockstepMembershipMachine.TestCase.settings = settings(
        max_examples=30, stateful_step_count=30, deadline=None)
    TestLockstepMembershipMachine = LockstepMembershipMachine.TestCase
