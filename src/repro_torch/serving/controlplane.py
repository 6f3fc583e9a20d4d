"""Fleet control plane: membership, placement, routing, and recovery
policy — the *decision* half of the serving engine, split out of the data
plane (``engine.RealEngine``).

The data plane moves bytes: it admits prompts, runs decode steps, stages
block copies, promotes replicas. Every *choice* it makes — who replicates
to whom, where a request routes, which spare rejoins when several
instances are down — is delegated here, so fleet-scale policies (8-16
instances, correlated failures, rejoin storms) evolve without touching the
byte-moving code, and the sim (``core/router.py``) shares the exact same
routing implementation instead of duplicating it.

Pieces:

* ``ClusterView`` — the membership truth: which instance ids are alive,
  each instance's degradation state (``HEALTHY`` | ``DEGRADED`` with the
  lost shard set | ``DEAD`` — a shard fault is NOT a kill), and a
  monotone ``epoch`` that bumps on every membership OR degradation
  change. Consumers that cache topology-derived state compare epochs
  instead of re-deriving the alive-set.
* ``PlacementPolicy`` — replication targeting. ``SuccessorPlacement`` is
  the classic ring (next-alive successor — the engine's historical
  behaviour, bit-for-bit). ``RendezvousPlacement`` is highest-random-
  weight hashing: each (source → candidate) pair gets a deterministic
  weight and the alive candidate with the highest weight wins, so a
  membership change re-targets ONLY the pairs whose winner left (or that
  the joiner now wins) — minimal re-hosting churn at fleet scale, where
  successor placement cascades re-targets through the ring.
* ``RoutingPolicy`` — request admission. ``LeastLoadedRouting`` is the
  one implementation both the real engine and the sim LB call: pick the
  candidate with the smallest (load, instance_id) key.
* ``RecoveryPlanner`` — coordinated multi-failure recovery: records every
  failure, orders rejoins (earliest failure first — the longest-degraded
  capacity returns first), serializes them one per engine step so each
  re-form settles (replicas re-host against the new topology) before the
  next membership change, and survives failure storms — a spare killed
  again right after (or while) rejoining is simply rescheduled.

``ControlPlane`` bundles the four; ``RealEngine`` owns one and
``server.py``'s ``/health`` serves ``describe()`` as the topology block.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.serving.api_types import DEAD, DEGRADED, HEALTHY

PLACEMENTS = ("successor", "rendezvous")


class ClusterView:
    """Membership + epoch for one LB group.

    The view is the single source of truth for "who is alive" at the
    policy layer: the engine marks failures/rejoins here in the same
    breath it flips ``RealInstance.alive``, and the transport checks the
    view at flush time, so a staged copy toward an instance that died (or
    was replaced by a fresh pool) between stage and flush is dropped, not
    scribbled."""

    def __init__(self, n_instances: int, roles: Optional[Dict] = None):
        self.n = n_instances
        self._alive = set(range(n_instances))
        self.epoch = 0
        # disaggregation roles (informational; routing filters on them at
        # the engine layer where the instance objects live)
        self.roles = dict(roles) if roles else {}
        # shard-level degradation: instance id -> set of lost shard
        # indices. A degraded instance is still ALIVE — it serves on its
        # surviving shards — but placement deprioritizes it and routing
        # discounts it. Death clears the record (DEAD dominates).
        self._degraded: Dict[int, set] = {}

    def is_alive(self, instance_id: int) -> bool:
        return instance_id in self._alive

    def alive_ids(self) -> List[int]:
        return sorted(self._alive)

    def n_alive(self) -> int:
        return len(self._alive)

    def mark_failed(self, instance_id: int) -> bool:
        """Record a death. Returns True (and bumps the epoch) iff the
        instance was alive — marking a dead instance dead is a no-op, so
        retried kills never inflate the epoch."""
        if instance_id not in self._alive:
            return False
        self._alive.discard(instance_id)
        # death supersedes degradation (the whole pool is gone); the fail
        # epoch bump below covers the state change
        self._degraded.pop(instance_id, None)
        self.epoch += 1
        return True

    def mark_alive(self, instance_id: int) -> bool:
        if instance_id in self._alive:
            return False
        self._alive.add(instance_id)
        self._degraded.pop(instance_id, None)   # a fresh instance is whole
        self.epoch += 1
        return True

    # -- shard-level degradation ------------------------------------------
    def mark_degraded(self, instance_id: int, shard_idx: int) -> bool:
        """Record a shard loss. Bumps the epoch iff the (alive) instance
        was not already missing that shard — degradation is a topology
        change consumers must re-derive against, exactly like a death."""
        if instance_id not in self._alive:
            return False
        lost = self._degraded.setdefault(instance_id, set())
        if shard_idx in lost:
            return False
        lost.add(shard_idx)
        self.epoch += 1
        return True

    def mark_restored(self, instance_id: int) -> bool:
        """All lost shards rejoined: the instance is HEALTHY again (its
        own epoch bump — the ring may prefer it as a target again)."""
        if self._degraded.pop(instance_id, None) is None:
            return False
        self.epoch += 1
        return True

    def is_degraded(self, instance_id: int) -> bool:
        return instance_id in self._alive and instance_id in self._degraded

    def lost_shards(self, instance_id: int) -> List[int]:
        return sorted(self._degraded.get(instance_id, ()))

    def state_of(self, instance_id: int) -> str:
        if instance_id not in self._alive:
            return DEAD
        return DEGRADED if instance_id in self._degraded else HEALTHY

    def snapshot(self) -> dict:
        return {"epoch": self.epoch, "n_instances": self.n,
                "alive": self.alive_ids(),
                "roles": {str(k): v for k, v in self.roles.items()},
                "degraded": {str(i): self.lost_shards(i)
                             for i in sorted(self._degraded)}}


class PlacementPolicy:
    """Replication targeting: where does instance ``i``'s failover state
    live? Implementations must be pure functions of (instance_id, view) —
    deterministic across processes, no hidden state — so every consumer
    (replication pass, failover, the /health topology block, property
    tests) derives the identical ring."""

    name = "base"

    def target(self, instance_id: int, view: ClusterView) -> int:
        """The replication target for ``instance_id`` under the current
        alive-set, or -1 when no valid target exists (fewer than two
        alive instances). Never returns ``instance_id`` itself and always
        returns an alive instance."""
        raise NotImplementedError

    def targets(self, view: ClusterView) -> Dict[int, int]:
        """The whole ring at once: alive instance -> its target."""
        return {i: self.target(i, view) for i in view.alive_ids()}


class SuccessorPlacement(PlacementPolicy):
    """The classic ring: the next alive instance id (mod n). Exactly the
    engine's historical ``_ring_target`` — kept as the default so existing
    deployments and byte-identity drills see zero behaviour change."""

    name = "successor"

    def target(self, instance_id: int, view: ClusterView) -> int:
        if view.n_alive() < 2:
            return -1
        # ring order, healthy candidates first: a DEGRADED instance is a
        # last-resort replica host (its surviving shards are already
        # oversubscribed) but still a valid one — when every candidate is
        # degraded the classic successor wins. With nothing degraded this
        # is bit-for-bit the historical next-alive walk.
        order = []
        idx = (instance_id + 1) % view.n
        for _ in range(view.n):
            if idx != instance_id and view.is_alive(idx):
                order.append(idx)
            idx = (idx + 1) % view.n
        for cand in order:
            if not view.is_degraded(cand):
                return cand
        return order[0]


class RendezvousPlacement(PlacementPolicy):
    """Highest-random-weight (rendezvous) placement.

    Each (source, candidate) pair hashes to a deterministic 64-bit weight;
    the alive candidate (excluding the source) with the highest weight
    hosts the source's replicas. The churn property successor placement
    lacks: when an instance dies, the ONLY sources that re-target are the
    ones whose winner died; when a spare rejoins, a source re-targets iff
    the joiner out-weighs its current winner (~1/n_alive of the fleet in
    expectation) — so an 8-16 instance fleet re-hosts a bounded slice of
    its replica bytes per membership change instead of cascading."""

    name = "rendezvous"

    @staticmethod
    def _weight(src: int, cand: int) -> int:
        digest = hashlib.blake2b(b"%d->%d" % (src, cand),
                                 digest_size=8).digest()
        return int.from_bytes(digest, "big")

    def target(self, instance_id: int, view: ClusterView) -> int:
        if view.n_alive() < 2:
            return -1
        # same deprioritization as the successor ring: highest weight
        # among HEALTHY candidates, falling back to the highest-weight
        # degraded one only when no healthy candidate exists — identical
        # to plain rendezvous whenever nothing is degraded
        best, best_w = -1, -1
        best_deg, best_deg_w = -1, -1
        for cand in view.alive_ids():
            if cand == instance_id:
                continue
            w = self._weight(instance_id, cand)
            if view.is_degraded(cand):
                if w > best_deg_w:
                    best_deg, best_deg_w = cand, w
            elif w > best_w:
                best, best_w = cand, w
        return best if best >= 0 else best_deg


def make_placement(name: str) -> PlacementPolicy:
    if name == "successor":
        return SuccessorPlacement()
    if name == "rendezvous":
        return RendezvousPlacement()
    raise ValueError(f"unknown placement policy {name!r} "
                     f"(choose from {PLACEMENTS})")


class LeastLoadedRouting:
    """THE least-loaded admission policy — the single implementation the
    real engine's ``_route``/overflow pass AND the sim LB
    (``core/router.py``) call, so the two paths can never drift. Load is
    caller-defined (the engine counts active slots + queued depth; the
    sim counts waiting + running); ties break on instance id, which keeps
    placement deterministic for identical loads.

    Wired to a ``ClusterView`` (the engine's construction), a DEGRADED
    candidate's load is multiplied by ``degraded_penalty`` — it serves
    each request on fewer shards, so equal queue depth is NOT equal
    capacity — and it loses exact ties to healthy peers. Without a view
    (the sim LB) the ordering is unchanged."""

    name = "least_loaded"

    def __init__(self, view: Optional[ClusterView] = None,
                 degraded_penalty: float = 2.0):
        self.view = view
        self.degraded_penalty = degraded_penalty

    def _key(self, cand, load: Callable[[object], int]):
        cost = load(cand)
        degraded = self.view is not None \
            and self.view.is_degraded(cand.instance_id)
        if degraded:
            cost = cost * self.degraded_penalty
        return (cost, 1 if degraded else 0, cand.instance_id)

    def pick(self, candidates: Sequence, load: Callable[[object], int]):
        """The admission target: smallest (effective load, instance_id)."""
        return min(candidates, key=lambda c: self._key(c, load))

    def order(self, candidates: Sequence, load: Callable[[object], int]):
        """Candidates from least to most loaded (peer-overflow order)."""
        return sorted(candidates, key=lambda c: self._key(c, load))


class RecoveryPlanner:
    """Coordinated recovery when one — or several — instances are down.

    The planner owns the rejoin schedule the engine used to keep inline:

    * ``on_failure`` records the death (and, with auto-rejoin, schedules
      the spare: failure time + delay);
    * ``next_due`` hands the engine AT MOST ONE due spare per step,
      ordered by failure time (earliest first — the capacity that has
      been missing longest returns first), ties by instance id.
      Serializing rejoins is deliberate: every rejoin bumps the epoch and
      re-targets part of the ring, and re-forming against a settled
      topology costs one re-host pass — re-forming against a topology
      that changes again next tick costs one per change;
    * storms are idempotent: a kill of an instance whose rejoin is still
      pending keeps the earlier failure time (its capacity has been gone
      since then) but pushes the ready time out; a spare killed right
      after rejoining is simply scheduled again.

    The planner never touches instances or pools — it answers "who, when,
    in what order"; the engine executes."""

    def __init__(self, view: ClusterView):
        self.view = view
        # instance_id -> {"fail_time", "ready_at", "kind"} for recoveries
        # not yet executed. kind "instance" = the classic spare rejoin;
        # kind "shard" = the instance is alive-but-degraded and the lost
        # shard(s) rejoin in place. One record per instance: a death
        # while a shard rejoin is pending upgrades the record to
        # "instance" (the whole pool is gone — restoring a shard of a
        # dead instance is meaningless).
        self._pending: Dict[int, Dict] = {}
        self.rejoins_planned = 0
        self.rejoins_completed = 0

    def on_failure(self, instance_id: int, t_fail: float,
                   rejoin_at: Optional[float] = None,
                   kind: str = "instance"):
        """Record a failure (whole-instance or single-shard); ``rejoin_at``
        schedules the recovery (None = manual — an admin recover clears
        the record)."""
        prior = self._pending.get(instance_id)
        fail_time = min(prior["fail_time"], t_fail) if prior else t_fail
        if prior is not None and "instance" in (prior["kind"], kind):
            kind = "instance"      # death dominates a pending shard rejoin
        if rejoin_at is None and prior is None:
            self._pending[instance_id] = {"fail_time": fail_time,
                                          "ready_at": float("inf"),
                                          "kind": kind}
            return
        ready = rejoin_at if rejoin_at is not None else prior["ready_at"]
        self._pending[instance_id] = {"fail_time": fail_time,
                                      "ready_at": ready, "kind": kind}
        if prior is None or rejoin_at is not None:
            self.rejoins_planned += 1

    def cancel(self, instance_id: int):
        self._pending.pop(instance_id, None)

    def pending_kind(self, instance_id: int) -> Optional[str]:
        """"instance" | "shard" for a pending record, None otherwise —
        the engine dispatches a due recovery on this."""
        rec = self._pending.get(instance_id)
        return rec["kind"] if rec else None

    def _stale(self, iid: int, rec: Dict) -> bool:
        """A record an admin already resolved by hand: an instance-kind
        record whose instance is alive again, or a shard-kind record whose
        instance is no longer degraded."""
        if rec["kind"] == "shard":
            return not self.view.is_degraded(iid)
        return self.view.is_alive(iid)

    def next_due(self, t: float) -> Optional[int]:
        """The one recovery to execute this step (or None) — instance and
        shard rejoins share the same earliest-failure-first order. Stale
        records — resolved by hand — are dropped, not returned, so a
        manual recover never collides with the schedule."""
        due = []
        for iid, rec in list(self._pending.items()):
            if self._stale(iid, rec):
                self._pending.pop(iid)       # manually recovered
                continue
            if t >= rec["ready_at"]:
                due.append((rec["fail_time"], iid))
        if not due:
            return None
        return min(due)[1]

    def on_rejoined(self, instance_id: int, t: float):
        if self._pending.pop(instance_id, None) is not None:
            self.rejoins_completed += 1

    def _ordered(self) -> List[tuple]:
        return sorted(self._pending.items(),
                      key=lambda kv: (kv[1]["fail_time"], kv[0]))

    def pending_rejoins(self) -> List[tuple]:
        """(instance_id, ready_at) pairs for SCHEDULED spares, rejoin
        order (legacy shape). Manual-recovery records (no rejoin time)
        are excluded: they resolve only when an admin acts, so they must
        not hold ``recovery_pending()`` — and with it drain loops — open
        forever."""
        return [(iid, rec["ready_at"]) for iid, rec in self._ordered()
                if rec["ready_at"] != float("inf")]

    def has_pending(self) -> bool:
        """True iff a *scheduled* rejoin is outstanding."""
        return any(rec["ready_at"] != float("inf")
                   for rec in self._pending.values())

    def plan(self, placement: PlacementPolicy) -> List[dict]:
        """The recovery plan as data — for /health and the runbook: each
        pending recovery (a down instance OR a degraded one awaiting its
        shard rejoin), its order, when it becomes due, its granularity,
        and the ring target the instance will replicate to once whole (a
        what-if against the view with the instance alive and healthy)."""
        out = []
        for order, (iid, rec) in enumerate(self._ordered()):
            ready = rec["ready_at"]
            whatif = ClusterView(self.view.n)
            whatif._alive = set(self.view._alive) | {iid}
            tgt = placement.target(iid, whatif)
            out.append({"instance": iid, "order": order,
                        "ready_at": ready if ready != float("inf") else -1.0,
                        "fail_time": rec["fail_time"],
                        "granularity": rec["kind"],
                        "ring_target_on_rejoin": tgt})
        return out

    def state(self) -> dict:
        return {"pending": len(self._pending),
                "rejoins_planned": self.rejoins_planned,
                "rejoins_completed": self.rejoins_completed}


class ControlPlane:
    """The bundle the engine owns: one view + one policy of each kind."""

    def __init__(self, n_instances: int, placement: str = "successor",
                 roles: Optional[Dict] = None,
                 degraded_load_penalty: float = 2.0):
        self.view = ClusterView(n_instances, roles=roles)
        self.placement = make_placement(placement)
        self.routing = LeastLoadedRouting(
            view=self.view, degraded_penalty=degraded_load_penalty)
        self.planner = RecoveryPlanner(self.view)

    def describe(self) -> dict:
        """The /health topology block: membership + epoch + per-instance
        degradation states + the live replication ring + the recovery
        plan (instance AND shard rejoins)."""
        return {
            **self.view.snapshot(),
            "states": {str(i): self.view.state_of(i)
                       for i in range(self.view.n)},
            "placement": self.placement.name,
            "routing": self.routing.name,
            "ring": {str(i): t
                     for i, t in self.placement.targets(self.view).items()},
            "planner": {**self.planner.state(),
                        "plan": self.planner.plan(self.placement)},
        }
