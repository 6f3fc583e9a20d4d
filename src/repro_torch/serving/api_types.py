"""Typed schemas for the serving HTTP API (the documented contract).

Two things live here:

* ``FaultSpec`` — the request body of the versioned admin endpoints
  (``POST /v1/admin/fault`` / ``POST /v1/admin/recover``) AND the single
  argument of the engine's unified fault entry points
  (``RealEngine.apply_fault`` / ``recover``). Instance- and
  shard-granularity faults are the same type, so the two drills share one
  code path end to end: HTTP handler -> service -> engine.
* the ``/health`` response schema — ``HealthResponse`` /
  ``TopologyBlock`` / ``InstanceStatus`` (+ the per-instance
  ``DegradationState``). The server builds these dataclasses instead of
  hand-assembling nested dicts; ``to_json()`` is the wire shape and
  ``from_json()`` round-trips it (tests/test_api_types.py), so a field
  rename is an API change you can see in the diff, not an accident.

Everything here is stdlib-only and JSON-plain: no numpy scalars, no jax —
``to_json()`` output must be ``json.dumps``-able as-is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

GRANULARITIES = ("instance", "shard")

# degradation states a ClusterView reports per instance
HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
DEAD = "DEAD"


@dataclasses.dataclass
class FaultSpec:
    """One fault (or recovery) order, typed.

    granularity  "instance": kill (or rejoin) the whole instance — the
                 classic drill.
                 "shard": lose (or restore) ONE tensor-parallel shard —
                 the instance degrades to its surviving slice instead of
                 dying.
    instance_id  which instance the order targets.
    shard_idx    required for shard faults (ignored by recover, which
                 restores ALL lost shards); must be None for instance
                 granularity.
    if_busy      apply the fault only if the instance has in-flight
                 requests (drills use this to guarantee the fault lands
                 on a serving instance). No-op -> the engine returns None.
    """

    granularity: str
    instance_id: int
    shard_idx: Optional[int] = None
    if_busy: bool = False

    def validate(self, n_instances: int, n_shards: int,
                 for_recover: bool = False):
        """Raise ValueError on a malformed spec (HTTP layer maps this to
        400 — shape errors, as opposed to state conflicts, which the
        engine raises and the HTTP layer maps to 409). ``for_recover``
        relaxes the shard_idx requirement: recovery restores ALL lost
        shards, so a shard-granularity recover may omit it."""
        if self.granularity not in GRANULARITIES:
            raise ValueError(
                f"granularity must be one of {GRANULARITIES}, "
                f"not {self.granularity!r}")
        if not isinstance(self.instance_id, int) or \
                not 0 <= self.instance_id < n_instances:
            raise ValueError(
                f"instance_id {self.instance_id!r} outside "
                f"[0, {n_instances})")
        if self.granularity == "shard":
            if for_recover and self.shard_idx is None:
                return
            if not isinstance(self.shard_idx, int) or \
                    not 0 <= self.shard_idx < n_shards:
                raise ValueError(
                    f"shard fault needs shard_idx in [0, {n_shards}), "
                    f"got {self.shard_idx!r}")
        elif self.shard_idx is not None:
            raise ValueError("instance-granularity spec must not carry a "
                             f"shard_idx (got {self.shard_idx!r})")

    def to_json(self) -> Dict[str, Any]:
        return {"granularity": self.granularity,
                "instance_id": self.instance_id,
                "shard_idx": self.shard_idx,
                "if_busy": self.if_busy}

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "FaultSpec":
        if not isinstance(obj, dict):
            raise ValueError(f"fault spec must be an object, got {obj!r}")
        unknown = set(obj) - {"granularity", "instance_id", "shard_idx",
                              "if_busy"}
        if unknown:
            raise ValueError(f"unknown fault spec field(s): "
                             f"{sorted(unknown)}")
        if "instance_id" not in obj:
            raise ValueError("fault spec needs instance_id")
        try:
            iid = int(obj["instance_id"])
        except (TypeError, ValueError):
            raise ValueError(
                f"instance_id must be an int, got {obj['instance_id']!r}")
        shard = obj.get("shard_idx")
        if shard is not None:
            try:
                shard = int(shard)
            except (TypeError, ValueError):
                raise ValueError(
                    f"shard_idx must be an int or null, got {shard!r}")
        return cls(granularity=obj.get("granularity", "instance"),
                   instance_id=iid, shard_idx=shard,
                   if_busy=bool(obj.get("if_busy", False)))


@dataclasses.dataclass
class DegradationState:
    """Per-instance degradation as /health reports it. ``layout`` is the
    sharding summary the engine computed when the instance degraded
    (``distributed.sharding.degradation_summary``): how many tensors stay
    model-sharded over the surviving slice vs fall back to replication."""

    state: str                       # HEALTHY | DEGRADED | DEAD
    n_shards: int
    lost_shards: List[int]
    slot_cap: int
    capacity_frac: float
    layout: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return {"state": self.state, "n_shards": self.n_shards,
                "lost_shards": list(self.lost_shards),
                "slot_cap": self.slot_cap,
                "capacity_frac": self.capacity_frac,
                "layout": self.layout}

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "DegradationState":
        return cls(state=obj["state"], n_shards=obj["n_shards"],
                   lost_shards=list(obj["lost_shards"]),
                   slot_cap=obj["slot_cap"],
                   capacity_frac=obj["capacity_frac"],
                   layout=obj.get("layout"))


@dataclasses.dataclass
class InstanceStatus:
    """One instance's row in /health."""

    id: int
    alive: bool
    role: str
    active: int
    queued: int
    prefilling: int
    handoffs_ready: int
    pool_used_blocks: int
    pool_replica_blocks: int
    degradation: DegradationState

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["degradation"] = self.degradation.to_json()
        return d

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "InstanceStatus":
        kw = dict(obj)
        kw["degradation"] = DegradationState.from_json(obj["degradation"])
        return cls(**kw)


@dataclasses.dataclass
class TopologyBlock:
    """The control plane's view of the fleet: membership epoch, per-
    instance degradation states, the replication ring, and the ordered
    recovery plan (``ControlPlane.describe()``'s shape, typed)."""

    epoch: int
    n_instances: int
    alive: List[int]
    roles: Dict[str, str]
    degraded: Dict[str, List[int]]   # instance id -> lost shard indices
    states: Dict[str, str]           # instance id -> HEALTHY|DEGRADED|DEAD
    placement: str
    routing: str
    ring: Dict[str, int]
    planner: Dict[str, Any]

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "TopologyBlock":
        return cls(**{f.name: obj[f.name]
                      for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class HealthResponse:
    """GET /health — the whole payload (docs/api.md documents it)."""

    status: str
    instances: List[InstanceStatus]
    queued: int
    completed: int
    recovery_mode: str
    failure_events: List[Dict[str, Any]]
    replication: Dict[str, Any]
    prefix: Dict[str, Any]
    disagg: Dict[str, Any]
    topology: TopologyBlock

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["instances"] = [i.to_json() for i in self.instances]
        d["topology"] = self.topology.to_json()
        return d

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "HealthResponse":
        kw = {f.name: obj[f.name] for f in dataclasses.fields(cls)}
        kw["instances"] = [InstanceStatus.from_json(i)
                           for i in obj["instances"]]
        kw["topology"] = TopologyBlock.from_json(obj["topology"])
        return cls(**kw)
