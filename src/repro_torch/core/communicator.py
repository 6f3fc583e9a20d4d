"""Decoupled model-parallelism initialization (paper Sec 3.2 mechanism #1).

The paper splits the classic 3-step serving bring-up
  (1) state-sharing store -> (2) collective communicator -> (3) weight load
so that (3) never has to be repeated when the topology changes: a new
communicator over surviving nodes + a donor is formed in seconds because
every participant already holds its weights.

Here a "communicator" is a topology-keyed handle to a built pipeline
program (a ``FamilyExecutor`` on the real path). Re-forming = building the
handle for a new node tuple; the cache makes repeat topologies free, and
node-resident weights make even cold re-forms cheap (no host<->device
weight movement). The sim path charges the calibrated costs; the real path
actually builds and runs the executor.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TopologySignature:
    """Identity of a pipeline communicator: which node serves which stage."""
    arch: str
    node_ids: Tuple[int, ...]          # by stage order

    @classmethod
    def of(cls, arch: str, nodes) -> "TopologySignature":
        return cls(arch, tuple(n.node_id for n in nodes))


@dataclasses.dataclass
class Communicator:
    signature: TopologySignature
    formed_at: float
    executable: Optional[Callable] = None   # real mode: built step program
    generation: int = 0


@dataclasses.dataclass
class InitCosts:
    """Calibrated bring-up costs (seconds): the reference's calibration to
    the paper's published numbers, not measured here. Defaults follow the
    paper:
    full re-init ~10 min (Jaiswal et al. 2025b), KevlarFlow re-form ~seconds
    (total MTTR ~30s including detection, Fig 8)."""
    state_store: float = 3.0          # state-sharing handshake (gRPC/TCPStore)
    communicator_form: float = 24.0   # pipeline communicator (re)construction
    weight_load: float = 540.0        # model weights from remote storage
    instance_provision: float = 35.0  # VM/container bring-up

    @property
    def full_init(self) -> float:     # standard fault behaviour path
        return (self.instance_provision + self.state_store
                + self.communicator_form + self.weight_load)

    @property
    def decoupled_reform(self) -> float:  # KevlarFlow path: no weight load
        return self.state_store + self.communicator_form


class CommunicatorManager:
    """Forms communicators; caches compiled executables by topology.

    ``build_executable`` (real mode) is called once per *new* signature —
    the decoupled-init dividend is visible as cache hits on re-forms back
    to a previously seen topology (e.g. after the home node is replaced).
    """

    def __init__(self, costs: Optional[InitCosts] = None,
                 build_executable: Optional[Callable] = None):
        self.costs = costs or InitCosts()
        self.build_executable = build_executable
        self._cache: Dict[TopologySignature, Communicator] = {}
        self._generation = 0
        self.stats = {"forms": 0, "cache_hits": 0, "compiles": 0}

    def form(self, arch: str, nodes, now: float) -> Tuple[Communicator, float]:
        """Form (or re-form) a communicator over ``nodes``.

        Returns (communicator, time_cost). Nodes must be healthy and hold
        their stage weights — the caller (recovery orchestrator) guarantees
        this; we verify, since forming a communicator over a node without
        weights would silently reintroduce the coupled init the paper
        removes."""
        for n in nodes:
            assert n.weights_loaded, f"{n} has no weights: decoupled init violated"
        sig = TopologySignature.of(arch, nodes)
        self.stats["forms"] += 1
        if sig in self._cache:
            self.stats["cache_hits"] += 1
            comm = self._cache[sig]
            comm.formed_at = now
            # cached executable: only the state-store handshake is paid
            return comm, self.costs.state_store
        executable = None
        if self.build_executable is not None:
            executable = self.build_executable(nodes)
            self.stats["compiles"] += 1
        self._generation += 1
        comm = Communicator(sig, now, executable, self._generation)
        self._cache[sig] = comm
        return comm, self.costs.decoupled_reform

    def legacy_init_cost(self) -> float:
        """What the standard fault behaviour pays to restore an instance."""
        return self.costs.full_init
