"""Background KV cache replication (paper Sec 3.2 mechanism #3).

Ring scheme over same-stage nodes of the LB group (Fig 2a yellow arrows):
node (i, s) replicates the KV blocks of its in-flight requests to node
((i+1) mod M, s). Properties implemented from the paper:

  * block-by-block background copies, budgeted per tick so replication
    never stalls request handling (the separate-CUDA-stream analogue);
  * targets exclude nodes currently involved in traffic rerouting
    (failed, donors, patched stages) — Fig 2b;
  * replicas are dropped first under memory pressure and recomputed later;
  * a per-(stage, tick) copy ordering with a group-wide lock order stands
    in for the paper's TCPStore distributed lock that breaks send/recv
    deadlocks in the ring.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set

from repro_torch.core.cluster import LoadBalancerGroup, NodeState, VirtualNode


@dataclasses.dataclass
class ReplicationConfig:
    enabled: bool = True
    # blocks per node per second of background budget; the reference's
    # calibration, chosen so normal-operation overhead stays in the paper's
    # 2-4% band (sim-clock figures, not measured on any device)
    blocks_per_second: float = 400.0
    page_size: int = 16
    runtime_overhead: float = 0.025     # fractional TPOT inflation when on


class ReplicationManager:
    def __init__(self, group: LoadBalancerGroup, cfg: ReplicationConfig):
        self.group = group
        self.cfg = cfg
        self._budget_carry: Dict[int, float] = {}
        self.stats = {"blocks_replicated": 0, "replicas_dropped": 0,
                      "hosted_rejected": 0, "promotions": 0}
        self._requests: Dict[int, object] = {}   # the last tick's lookup
        for node in group.nodes:
            self.watch(node)

    def watch(self, node: VirtualNode):
        """Follow pressure evictions on ``node``'s pool (real pools only):
        a replica evicted there is no longer counted by its source."""
        if node.kv_pool.real:
            node.kv_pool.on_replica_evicted = self._replica_evicted

    def _replica_evicted(self, peer: int, rid: int, logical):
        """A target evicted the replica of ``peer``'s request ``rid``
        (pages ``logical``): clear those blocks' flags on the source, and
        lower the request's ``replicated_through`` to what is still
        hosted, so a failure before the next tick restarts or resumes only
        from promoted pages, never "seamlessly" from an empty table."""
        source = self.group.node_by_id.get(peer)
        if source is None:
            return
        gone = set(logical)
        table = source.kv_pool.table(rid)
        for block in table:
            if block.logical_idx in gone:
                block.replicated = False
        req = self._requests.get(rid)
        if req is not None:
            req.replicated_through = min(
                req.replicated_through,
                sum(b.n_filled for b in table if b.replicated))

    # -- target selection ----------------------------------------------------
    def excluded_nodes(self) -> Set[int]:
        """Nodes excluded from the replication ring (paper Fig 2b): failed
        nodes, donors serving extra roles, and patched-stage participants."""
        out: Set[int] = set()
        for n in self.group.nodes:
            if n.state != NodeState.HEALTHY or len(n.roles) != 1:
                out.add(n.node_id)
        for inst in self.group.instances:
            if not inst.is_serving():
                for n in inst.home_nodes:
                    out.add(n.node_id)
        return out

    def target_for(self, node: VirtualNode) -> Optional[VirtualNode]:
        """Next same-stage node around the ring, skipping excluded nodes."""
        if not self.cfg.enabled:
            return None
        excluded = self.excluded_nodes()
        if node.node_id in excluded:
            return None
        stage = node.signature.stage
        m = len(self.group.instances)
        peers = []
        for off in range(1, m):
            j = (node.home_instance + off) % m
            cand = self.group.instances[j].home_nodes[stage]
            if cand.node_id not in excluded and cand.state == NodeState.HEALTHY:
                peers.append(cand)
        return peers[0] if peers else None

    def target_for_failed(self, node: VirtualNode) -> Optional[VirtualNode]:
        """Where a (now-failed) node's replicas live: its ring target as of
        before the failure. Used by recovery to pick the donor so that
        promoted replicas are already resident (paper Fig 2b: donor (1,2)
        is exactly node (0,2)'s replication target)."""
        stage = node.signature.stage
        m = len(self.group.instances)
        excluded = self.excluded_nodes() - {node.node_id}
        for off in range(1, m):
            j = (node.home_instance + off) % m
            cand = self.group.instances[j].home_nodes[stage]
            if cand.state == NodeState.HEALTHY and cand.node_id not in excluded:
                return cand
        return None

    # -- background tick -----------------------------------------------------
    def tick(self, dt: float, request_lookup: Dict[int, object]):
        """Advance background replication by dt seconds on every node.

        Nodes are visited in node-id order (the distributed-lock total order
        that avoids ring deadlocks). Each node copies up to its budget of
        unreplicated blocks for its live requests, oldest request first."""
        if not self.cfg.enabled:
            return
        self._requests = request_lookup
        for node in sorted(self.group.nodes, key=lambda n: n.node_id):
            if node.state != NodeState.HEALTHY:
                continue
            target = self.target_for(node)
            if target is None:
                continue
            budget = self._budget_carry.get(node.node_id, 0.0) \
                + self.cfg.blocks_per_second * dt
            for rid in node.kv_pool.live_requests():
                if budget < 1.0:
                    break
                table = node.kv_pool.table(rid)
                pending = [b for b in table if not b.replicated and b.n_filled > 0]
                if not pending:
                    continue
                hosted = target.kv_pool.replica_table(node.node_id, rid)
                n_hosted = len(hosted)
                need_host = len([b for b in table if b.n_filled > 0]) - len(hosted)
                if need_host > 0:
                    if not target.kv_pool.host_replica(node.node_id, rid, need_host):
                        # target under pressure: drop someone else's replicas
                        target.kv_pool.evict_replicas_for_pressure(need_host)
                        if not target.kv_pool.host_replica(node.node_id, rid,
                                                           need_host):
                            self.stats["hosted_rejected"] += 1
                            continue
                if target.kv_pool.real:
                    budget = self._copy_real(node, target, rid, table, pending,
                                             hosted, n_hosted, budget)
                else:
                    # metadata pools hold no bytes: only the flags move
                    for block in pending:
                        if budget < 1.0:
                            break
                        block.replicated = True
                        budget -= 1.0
                        self.stats["blocks_replicated"] += 1
                req = request_lookup.get(rid)
                if req is not None:
                    done = sum(b.n_filled for b in table if b.replicated)
                    req.replicated_through = done
                    req.replica_node = target.node_id
            self._budget_carry[node.node_id] = min(budget, self.cfg.blocks_per_second)

    def _copy_real(self, node: VirtualNode, target: VirtualNode, rid: int,
                   table, pending, hosted, n_hosted: int,
                   budget: float) -> float:
        """One request's copies between real pools; returns the budget left.

        Each block lands in the slot the target hosts for its logical index
        (the target's own slot numbering). A replica that pressure evicted
        is re-hosted from logical 0 and can be shorter than the table, so:
        pages hosted afresh in this tick are filled from the primary at
        once, and a block without a hosted page is not replicated (its flag
        is cleared, and it counts in neither the stats nor
        ``replicated_through``). A promoted replica then holds only the
        primary's bytes, for just the tokens the request reports."""
        now = target.kv_pool.replica_table(node.node_id, rid)
        # host_replica grows the same table; an evicted one is a new list
        fresh = now[n_hosted:] if now is hosted else now
        dst = {ref.logical_idx: ref.slot for ref in now}
        by_idx = {b.logical_idx: b for b in table}
        copies = {ref.logical_idx: ref.slot for ref in fresh
                  if ref.logical_idx in by_idx}
        for block in table:
            if block.logical_idx not in dst:
                block.replicated = False
        for block in pending:
            if budget < 1.0:
                break
            slot = dst.get(block.logical_idx)
            if slot is None:
                continue
            copies[block.logical_idx] = slot
            block.replicated = True
            budget -= 1.0
            self.stats["blocks_replicated"] += 1
        for i in copies:
            # a page hosted afresh holds the primary's bytes from now on,
            # whether or not an eviction cleared its block's flag
            if by_idx[i].n_filled > 0:
                by_idx[i].replicated = True
        order = sorted(copies)
        node.kv_pool.copy_blocks_to(target.kv_pool,
                                    [by_idx[i].slot for i in order],
                                    [copies[i] for i in order])
        return budget

    # -- failure path ----------------------------------------------------------
    def replicated_tokens(self, node: VirtualNode, rid: int) -> int:
        table = node.kv_pool.table(rid)
        return sum(b.n_filled for b in table if b.replicated)

    def promote(self, failed_node_id: int, target: VirtualNode, rid: int):
        """In-flight request resumes on its replication target: hosted
        replica blocks become primary blocks there (paper: 'continued
        near-instantly on a live node')."""
        refs = target.kv_pool.promote_replica(failed_node_id, rid)
        self.stats["promotions"] += 1
        return refs

    def drop_replicas_on(self, node: VirtualNode, of_peer: int):
        node.kv_pool.drop_all_replicas_from(of_peer)
        self.stats["replicas_dropped"] += 1

    def overhead_factor(self) -> float:
        return 1.0 + (self.cfg.runtime_overhead if self.cfg.enabled else 0.0)
