"""Cluster state machine: VirtualNode / PipelineInstance / LoadBalancerGroup.

This is KevlarFlow's "flexible pool of resources" view (paper Sec 3.2):
a load-balancing group of M pipeline instances x P stages, where any healthy
node holding stage-s weights can serve stage s of ANY instance in the group.

Fail-stutter states:
  HEALTHY   - all stages served by their home nodes
  DEGRADED  - >=1 stage served by a borrowed donor node (traffic rerouted)
  OFFLINE   - standard fault behaviour only: whole pipeline down
  RECOVERING- communicator re-forming (brief; requests buffered)
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from repro_torch.serving.kvcache import PagedKVPool


class NodeState(enum.Enum):
    HEALTHY = "healthy"
    FAILED = "failed"
    PROVISIONING = "provisioning"   # background replacement being initialized


class InstanceState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    RECOVERING = "recovering"
    OFFLINE = "offline"


@dataclasses.dataclass
class StageSignature:
    """What weights a node holds. A donor can replace a failed node only if
    signatures match (same stage shard; for MoE also the same expert
    shard)."""
    arch: str
    stage: int
    n_stages: int
    expert_shard: int = 0

    def compatible(self, other: "StageSignature") -> bool:
        return (self.arch, self.stage, self.n_stages, self.expert_shard) == \
               (other.arch, other.stage, other.n_stages, other.expert_shard)


class VirtualNode:
    """One serving node: holds one pipeline stage's weights + a paged KV pool.

    ``roles`` tracks which (instance, stage) slots this node currently
    serves. len(roles) > 1 means it is donating capacity to a patched
    pipeline — each role gets an equal share (paper: the capacity drop is
    limited strictly to the failed node)."""

    def __init__(self, node_id: int, home_instance: int, signature: StageSignature,
                 kv_pool: PagedKVPool, weights=None):
        self.node_id = node_id
        self.home_instance = home_instance
        self.signature = signature
        self.kv_pool = kv_pool
        self.weights = weights              # real-compute mode: stage params
        self.state = NodeState.HEALTHY
        self.roles: List[tuple] = [(home_instance, signature.stage)]
        self.weights_loaded = True
        self.last_heartbeat = 0.0

    @property
    def capacity_share(self) -> float:
        """Fraction of this node's throughput available per role."""
        return 1.0 / max(len(self.roles), 1)

    def serves(self, instance_id: int, stage: int) -> bool:
        return (instance_id, stage) in self.roles

    def fail(self):
        self.state = NodeState.FAILED
        self.roles = []

    def __repr__(self):
        return (f"Node({self.node_id}, inst={self.home_instance}, "
                f"stage={self.signature.stage}, {self.state.value}, "
                f"roles={self.roles})")


class PipelineInstance:
    """One model replica: an ordered list of stage->node assignments."""

    def __init__(self, instance_id: int, nodes: List[VirtualNode]):
        self.instance_id = instance_id
        self.home_nodes = list(nodes)           # original assignment
        self.stage_nodes: List[VirtualNode] = list(nodes)  # current (may patch)
        self.state = InstanceState.HEALTHY
        self.recovering_until = -1.0
        self.offline_until = -1.0
        # requests currently running on this pipeline (rids)
        self.running: List = []
        self.waiting: List = []

    @property
    def n_stages(self) -> int:
        return len(self.home_nodes)

    def is_serving(self) -> bool:
        return self.state in (InstanceState.HEALTHY, InstanceState.DEGRADED)

    def throughput_multiplier(self) -> float:
        """min over stages of the serving node's capacity share; 0 if any
        stage has no healthy node. A patched pipeline with one shared donor
        runs at (P-1+share)/P of nominal *throughput* — we account the
        donor's split share at the bottleneck stage."""
        if not self.is_serving():
            return 0.0
        mult = 1.0
        total = 0.0
        for s, node in enumerate(self.stage_nodes):
            if node is None or node.state != NodeState.HEALTHY:
                return 0.0
            share = node.capacity_share
            mult = min(mult, share)
            total += share
        # Pipeline with continuous batching: stages overlap, so effective
        # throughput scales with aggregate stage capacity (paper Sec 3.2:
        # "the capacity drop is limited strictly to the failed node").
        return total / self.n_stages

    def patched_stages(self) -> List[int]:
        return [s for s, (h, c) in
                enumerate(zip(self.home_nodes, self.stage_nodes)) if h is not c]


class LoadBalancerGroup:
    """The fault-tolerance group: all instances serving the same model."""

    def __init__(self, instances: List[PipelineInstance], nodes: List[VirtualNode]):
        self.instances = instances
        self.nodes = nodes
        self.node_by_id = {n.node_id: n for n in nodes}

    def serving_instances(self) -> List[PipelineInstance]:
        return [i for i in self.instances if i.is_serving()]

    def total_capacity(self) -> float:
        return sum(i.throughput_multiplier() for i in self.instances)

    def find_donor(self, signature: StageSignature,
                   exclude: Optional[set] = None) -> Optional[VirtualNode]:
        """Locate a healthy node in the group holding the same weights
        (paper Sec 4.3 step 1). Prefer the least-loaded (fewest roles)."""
        exclude = exclude or set()
        candidates = [
            n for n in self.nodes
            if n.state == NodeState.HEALTHY
            and n.node_id not in exclude
            and n.signature.compatible(signature)
            and n.weights_loaded
        ]
        if not candidates:
            return None
        return min(candidates, key=lambda n: (len(n.roles), n.node_id))

    def nodes_of(self, instance_id: int) -> List[VirtualNode]:
        return self.instances[instance_id].stage_nodes


def build_group(n_instances: int, n_stages: int, arch: str = "llama3-8b",
                kv_blocks_per_node: int = 2048, page_size: int = 16,
                real_pools: bool = False, pool_kw: Optional[dict] = None) -> LoadBalancerGroup:
    """Construct an M-instance x P-stage LB group (paper: 2x4 and 4x4).
    Pools are metadata-only unless ``real_pools``; ``pool_kw`` goes to the
    port's ``PagedKVPool`` (geometry, dtype, ``device``)."""
    nodes, instances = [], []
    nid = 0
    for i in range(n_instances):
        inst_nodes = []
        for s in range(n_stages):
            sig = StageSignature(arch=arch, stage=s, n_stages=n_stages)
            pool = PagedKVPool(kv_blocks_per_node, page_size,
                               real=real_pools, **(pool_kw or {}))
            node = VirtualNode(nid, i, sig, pool)
            nodes.append(node)
            inst_nodes.append(node)
            nid += 1
        instances.append(PipelineInstance(i, inst_nodes))
    return LoadBalancerGroup(instances, nodes)
