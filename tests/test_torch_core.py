"""The port's simulated cluster (``core/``) at the unit level.

Every test of ``tests/test_cluster.py`` and ``tests/test_replication.py``
runs here on both packages (one parametrize case each). Then exact parity
with the reference: group topologies, donor choice, throughput
multipliers, ring exclusions and targets over seeded failure sequences;
replication one tick at a time (flags, stats, every pool's tables and free
count); the communicator cache; and the router's least-loaded policy being
the port control plane's own class. Last, the port's replication on REAL
CPU pools: each block lands in the hosted replica's slot, so a promoted
replica holds the primary's bytes."""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

PACKAGES = ("repro", "repro_torch")


def _load(pkg):
    mods = ("core.cluster", "core.communicator", "core.replication",
            "core.router", "core.system", "serving.request",
            "serving.controlplane")
    return SimpleNamespace(**{m.split(".")[1]: importlib.import_module(
        f"{pkg}.{m}") for m in mods})


@pytest.fixture(params=PACKAGES)
def P(request):
    return _load(request.param)


J, T = _load("repro"), _load("repro_torch")


# -- tests/test_cluster.py, on both packages ---------------------------------

def test_group_topology(P):
    g = P.cluster.build_group(4, 4)
    assert len(g.nodes) == 16
    assert all(len(i.home_nodes) == 4 for i in g.instances)
    assert g.total_capacity() == 4.0


def test_donor_selection_same_stage_only(P):
    g = P.cluster.build_group(2, 4)
    failed = g.instances[0].home_nodes[2]
    donor = g.find_donor(failed.signature, exclude={failed.node_id})
    assert donor is g.instances[1].home_nodes[2]       # same stage, sibling


def test_capacity_multiplier_patched(P):
    """Paper Sec 3.2: a 2x4 group with one failure keeps 7/8 of its
    capacity."""
    g = P.cluster.build_group(2, 4)
    failed = g.instances[0].home_nodes[2]
    donor = g.instances[1].home_nodes[2]
    failed.fail()
    g.instances[0].stage_nodes[2] = donor
    donor.roles.append((0, 2))
    assert g.instances[0].throughput_multiplier() == pytest.approx(7 / 8)
    assert g.instances[1].throughput_multiplier() == pytest.approx(7 / 8)
    assert g.total_capacity() == pytest.approx(2 * 7 / 8)


def test_decoupled_init_costs(P):
    """The 20x MTTR claim reduces to: re-form never pays the weight load."""
    c = P.communicator.InitCosts()
    assert c.decoupled_reform < 30
    assert c.full_init > 590                 # ~10 min (paper)
    assert c.full_init / c.decoupled_reform > 15


def test_communicator_cache_hits(P):
    g = P.cluster.build_group(2, 4)
    mgr = P.communicator.CommunicatorManager()
    comm1, cost1 = mgr.form("llama3-8b", g.instances[0].stage_nodes, 0.0)
    comm2, cost2 = mgr.form("llama3-8b", g.instances[0].stage_nodes, 1.0)
    assert comm1.signature == comm2.signature
    assert mgr.stats["cache_hits"] == 1
    assert cost2 < cost1                     # cached topology re-forms faster


def test_replication_ring_excludes_degraded(P):
    g = P.cluster.build_group(3, 4)
    mgr = P.replication.ReplicationManager(
        g, P.replication.ReplicationConfig())
    n0 = g.instances[0].home_nodes[1]
    assert mgr.target_for(n0) is g.instances[1].home_nodes[1]
    # fail instance 1's stage-1 node: ring skips to instance 2
    g.instances[1].home_nodes[1].fail()
    assert mgr.target_for(n0) is g.instances[2].home_nodes[1]
    # a donor (multi-role) node is excluded as a target
    g.instances[2].home_nodes[1].roles.append((1, 1))
    assert mgr.target_for(n0) is None


def test_kevlarflow_recovery_end_to_end(P):
    sys_ = P.system.ServingSystem(n_instances=2, mode="kevlarflow")
    req = P.request.Request(rid=1, prompt_len=64, max_new_tokens=400,
                            arrival_time=0.0)
    sys_.submit(req)
    for _ in range(100):                      # get the request into decode
        sys_.step(0.05)
    assert req.state == P.request.RequestState.DECODE
    victim = sys_.group.instances[req.instance_id].home_nodes[2]
    sys_.inject_failure(at=sys_.clock.now(), node_id=victim.node_id)
    for _ in range(1200):                     # ride through recovery
        sys_.step(0.05)
    inst = sys_.group.instances[req.instance_id]
    assert inst.state in (P.cluster.InstanceState.DEGRADED,
                          P.cluster.InstanceState.HEALTHY)
    assert req.n_retries == 0                 # KevlarFlow: never restarted
    assert req.n_migrations >= 1
    ev = sys_.mttr_events()[0]
    assert 20 <= ev.mttr <= 45                # paper Fig 8: ~30 s


def test_standard_behaviour_restarts_requests(P):
    sys_ = P.system.ServingSystem(n_instances=2, mode="standard")
    req = P.request.Request(rid=1, prompt_len=64, max_new_tokens=400,
                            arrival_time=0.0)
    sys_.submit(req)
    for _ in range(100):
        sys_.step(0.05)
    victim = sys_.group.instances[req.instance_id].home_nodes[2]
    sys_.inject_failure(at=sys_.clock.now(), node_id=victim.node_id)
    for _ in range(400):
        sys_.step(0.05)
    assert req.n_retries == 1                 # paper: immediate retry
    # instance unusable for the full re-init (~10 min)
    assert sys_.group.instances[victim.home_instance].state == \
        P.cluster.InstanceState.OFFLINE


def test_donor_failure_cascade(P):
    """If the donor itself later fails, both instances recover again."""
    sys_ = P.system.ServingSystem(n_instances=3, mode="kevlarflow")
    sys_.inject_failure(
        at=1.0, node_id=sys_.group.instances[0].home_nodes[1].node_id)
    for _ in range(1000):
        sys_.step(0.05)
    donor = sys_.group.instances[0].stage_nodes[1]
    assert donor.home_instance == 1 and len(donor.roles) == 2
    sys_.inject_failure(at=sys_.clock.now(), node_id=donor.node_id)
    for _ in range(1200):
        sys_.step(0.05)
    for inst in sys_.group.instances:
        assert inst.is_serving()
        assert all(n.state == P.cluster.NodeState.HEALTHY
                   for n in inst.stage_nodes)


# -- tests/test_replication.py, on both packages ------------------------------

def _repl_setup(P, n_instances=2, blocks=64):
    g = P.cluster.build_group(n_instances, 4, kv_blocks_per_node=blocks)
    mgr = P.replication.ReplicationManager(
        g, P.replication.ReplicationConfig(blocks_per_second=1000))
    return g, mgr


def test_background_tick_replicates_blocks(P):
    g, mgr = _repl_setup(P)
    req = P.request.Request(rid=1, prompt_len=64, max_new_tokens=10,
                            arrival_time=0.0)
    node = g.instances[0].home_nodes[0]
    node.kv_pool.allocate(1, 64)
    mgr.tick(1.0, {1: req})
    target = g.instances[1].home_nodes[0]
    assert target.kv_pool.replica_table(node.node_id, 1)
    assert req.replicated_through == 64
    assert all(b.replicated for b in node.kv_pool.table(1))


def test_budget_limits_replication_rate(P):
    g, mgr = _repl_setup(P)
    mgr.cfg = P.replication.ReplicationConfig(blocks_per_second=2)
    node = g.instances[0].home_nodes[0]
    node.kv_pool.allocate(1, 16 * 10)                     # 10 blocks
    req = P.request.Request(rid=1, prompt_len=160, max_new_tokens=1,
                            arrival_time=0)
    mgr.tick(1.0, {1: req})
    done = sum(b.replicated for b in node.kv_pool.table(1))
    assert done == 2                                      # budget respected


def test_new_tokens_dirty_blocks(P):
    g, mgr = _repl_setup(P)
    node = g.instances[0].home_nodes[0]
    node.kv_pool.allocate(1, 16)
    req = P.request.Request(rid=1, prompt_len=16, max_new_tokens=8,
                            arrival_time=0)
    mgr.tick(1.0, {1: req})
    assert req.replicated_through == 16
    node.kv_pool.append_token(1)          # dirties the (partial) last block
    assert not node.kv_pool.table(1)[-1].replicated
    mgr.tick(1.0, {1: req})
    assert req.replicated_through == 17


def test_target_pressure_evicts_other_replicas(P):
    g, mgr = _repl_setup(P, blocks=8)
    target = g.instances[1].home_nodes[0]
    target.kv_pool.host_replica(99, 50, 6)                # mostly full
    node = g.instances[0].home_nodes[0]
    node.kv_pool.allocate(1, 16 * 4)
    req = P.request.Request(rid=1, prompt_len=64, max_new_tokens=1,
                            arrival_time=0)
    mgr.tick(1.0, {1: req})
    # stale peer-99 replicas were evicted to make room
    assert target.kv_pool.replica_table(node.node_id, 1)
    assert not target.kv_pool.replica_table(99, 50)


def test_overhead_factor_in_paper_band(P):
    g, mgr = _repl_setup(P)
    assert 1.0 < mgr.overhead_factor() <= 1.05            # Fig 9: <= ~4%
    mgr.cfg = P.replication.ReplicationConfig(enabled=False)
    assert mgr.overhead_factor() == 1.0


def test_promotion_on_failure_path(P):
    g, mgr = _repl_setup(P)
    node = g.instances[0].home_nodes[2]
    target = mgr.target_for(node)
    node.kv_pool.allocate(7, 48)
    req = P.request.Request(rid=7, prompt_len=48, max_new_tokens=1,
                            arrival_time=0)
    mgr.tick(1.0, {7: req})
    node.fail()
    resumed_on = mgr.target_for_failed(node)
    assert resumed_on is target
    refs = mgr.promote(node.node_id, resumed_on, 7)
    assert len(refs) == 3
    assert resumed_on.kv_pool.n_tokens(7) == 48


# -- exact parity with the reference ------------------------------------------

def _ids(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [_ids(n) for n in x]
    return x.node_id


def _group_view(g):
    return {
        "nodes": [(n.node_id, n.home_instance, n.signature.arch,
                   n.signature.stage, n.signature.n_stages,
                   n.signature.expert_shard, n.state.value, list(n.roles),
                   n.weights_loaded, n.capacity_share, n.kv_pool.n_blocks,
                   n.kv_pool.page_size, n.kv_pool.n_free)
                  for n in g.nodes],
        "instances": [(i.instance_id, i.state.value, _ids(i.home_nodes),
                       _ids(i.stage_nodes), i.n_stages, i.is_serving(),
                       i.throughput_multiplier(), i.patched_stages())
                      for i in g.instances],
        "capacity": g.total_capacity(),
        "serving": [i.instance_id for i in g.serving_instances()],
    }


def _ring_view(g, mgr):
    return {
        "excluded": sorted(mgr.excluded_nodes()),
        "target_for": {n.node_id: _ids(mgr.target_for(n)) for n in g.nodes},
        "target_for_failed": {n.node_id: _ids(mgr.target_for_failed(n))
                              for n in g.nodes},
        "donor": {n.node_id: _ids(g.find_donor(n.signature,
                                               exclude={n.node_id}))
                  for n in g.nodes},
    }


def _patch(g, inst_id, stage, donor):
    """What a completed KevlarFlow re-form does to the topology."""
    g.instances[inst_id].stage_nodes[stage] = donor
    donor.roles.append((inst_id, stage))


@pytest.mark.parametrize("m,p", [(1, 1), (2, 4), (3, 2), (4, 4), (6, 3)])
def test_build_group_topology_equals_reference(m, p):
    gj = J.cluster.build_group(m, p, arch="mixtral-8x7b",
                               kv_blocks_per_node=96, page_size=8)
    gt = T.cluster.build_group(m, p, arch="mixtral-8x7b",
                               kv_blocks_per_node=96, page_size=8)
    assert _group_view(gt) == _group_view(gj)
    assert all(not n.kv_pool.real for n in gt.nodes)
    assert [repr(n) for n in gt.nodes] == [repr(n) for n in gj.nodes]


@pytest.mark.parametrize("m,p", [(2, 4), (3, 4), (4, 4), (5, 2)])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ring_and_donors_equal_reference_over_failures(seed, m, p):
    """Seeded sequences of kills, donor patches, extra roles and instance
    outages: the same exclusions, ring targets, failed-node targets, donor
    choices and throughput multipliers (float for float) on both."""
    rng = np.random.default_rng(seed)
    gj, gt = J.cluster.build_group(m, p), T.cluster.build_group(m, p)
    mj = J.replication.ReplicationManager(gj,
                                          J.replication.ReplicationConfig())
    mt = T.replication.ReplicationManager(gt,
                                          T.replication.ReplicationConfig())
    assert _ring_view(gt, mt) == _ring_view(gj, mj)
    for _ in range(3 * m):
        op = int(rng.integers(4))
        nid = int(rng.integers(len(gj.nodes)))
        for g in (gj, gt):
            node = g.nodes[nid]
            inst = g.instances[node.home_instance]
            stage = node.signature.stage
            if op == 0:
                node.fail()
            elif op == 1 and node.state.value == "failed":
                # re-form onto a donor, as recovery does
                donor = g.find_donor(node.signature, exclude={nid})
                if donor is not None:
                    _patch(g, inst.instance_id, stage, donor)
                    inst.state = type(inst.state)("degraded")
            elif op == 2:
                inst.state = type(inst.state)("offline")
            elif op == 3:
                inst.state = type(inst.state)("healthy")
        assert _group_view(gt) == _group_view(gj)
        assert _ring_view(gt, mt) == _ring_view(gj, mj)


def _pool_view(pool):
    return {
        "n_free": pool.n_free,
        "free": list(pool._free),
        "tables": {rid: [(b.logical_idx, b.slot, b.n_filled, b.replicated)
                         for b in pool.table(rid)]
                   for rid in pool.live_requests()},
        "replicas": {k: [(b.logical_idx, b.slot, b.n_filled)
                         for b in v]
                     for k, v in pool._replica_tables.items()},
    }


def _tick_view(g, mgr, reqs):
    return {
        "pools": [_pool_view(n.kv_pool) for n in g.nodes],
        "stats": dict(mgr.stats),
        "carry": dict(mgr._budget_carry),
        "reqs": {rid: (r.replicated_through, r.replica_node)
                 for rid, r in reqs.items()},
    }


@pytest.mark.parametrize("blocks,bps", [(64, 37.0), (24, 400.0), (12, 9.0)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replication_tick_by_tick_equals_reference(seed, blocks, bps):
    """Random allocations, token appends, frees, failures and dt's on a
    3 x 4 group, one replication tick at a time: every pool's tables,
    free list and hosted replicas, the stats, the budget carry and each
    request's replicated_through / replica_node are equal."""
    rng = np.random.default_rng(seed)
    sides = []
    for P in (J, T):
        g = P.cluster.build_group(3, 4, kv_blocks_per_node=blocks)
        mgr = P.replication.ReplicationManager(
            g, P.replication.ReplicationConfig(blocks_per_second=bps))
        sides.append((P, g, mgr, {}))
    next_rid = 0
    for step in range(120):
        op = rng.random()
        nid = int(rng.integers(12))
        n_tok = int(rng.integers(1, 70))
        dt = float(rng.choice([0.01, 0.05, 0.1, 0.5]))
        for P, g, mgr, reqs in sides:
            pool = g.nodes[nid].kv_pool
            live = pool.live_requests()
            if op < 0.3:
                rid = next_rid
                reqs[rid] = P.request.Request(rid=rid, prompt_len=n_tok,
                                              max_new_tokens=8,
                                              arrival_time=0.0)
                try:
                    pool.allocate(rid, n_tok)
                except MemoryError:
                    pool.evict_replicas_for_pressure(
                        pool.blocks_for_tokens(n_tok))
            elif op < 0.7 and live:
                rid = live[int(n_tok) % len(live)]
                for _ in range(n_tok % 20):
                    try:
                        pool.append_token(rid)
                    except MemoryError:
                        break
            elif op < 0.8 and live:
                rid = live[0]
                for node in g.nodes:
                    node.kv_pool.free(rid)
                    for peer in list(g.node_by_id):
                        node.kv_pool.drop_replica(peer, rid)
            elif op < 0.83 and step > 40:
                g.nodes[nid].fail()
            elif op < 0.86:
                mgr.drop_replicas_on(g.nodes[nid], (nid + 4) % 12)
            mgr.tick(dt, reqs)
        if op < 0.3:
            next_rid += 1
        assert _tick_view(sides[1][1], sides[1][2], sides[1][3]) == \
            _tick_view(sides[0][1], sides[0][2], sides[0][3])


def test_communicator_manager_equals_reference():
    """Forms over a sequence of topologies: the same signatures,
    generations, returned costs and forms / cache_hits / compiles."""
    built = {"j": [], "t": []}
    out = []
    for P, key in ((J, "j"), (T, "t")):
        g = P.cluster.build_group(2, 4)
        mgr = P.communicator.CommunicatorManager(
            build_executable=lambda nodes, k=key: built[k].append(
                tuple(n.node_id for n in nodes)) or len(built[k]))
        home = g.instances[0].stage_nodes
        patched = list(home)
        patched[2] = g.instances[1].home_nodes[2]
        seq = [home, g.instances[1].stage_nodes, patched, home, patched,
               home]
        res = []
        for t, nodes in enumerate(seq):
            comm, cost = mgr.form("llama3-8b", nodes, float(t))
            res.append((comm.signature.arch, comm.signature.node_ids,
                        comm.generation, comm.formed_at, comm.executable,
                        cost))
        out.append((res, dict(mgr.stats), mgr.legacy_init_cost()))
    assert out[1] == out[0]
    assert built["t"] == built["j"] == [(0, 1, 2, 3), (4, 5, 6, 7),
                                        (0, 1, 6, 3)]
    assert out[1][1] == {"forms": 6, "cache_hits": 3, "compiles": 3}


def test_communicator_form_requires_resident_weights():
    g = T.cluster.build_group(2, 4)
    mgr = T.communicator.CommunicatorManager()
    g.instances[0].stage_nodes[1].weights_loaded = False
    with pytest.raises(AssertionError, match="decoupled init violated"):
        mgr.form("llama3-8b", g.instances[0].stage_nodes, 0.0)
    assert mgr.stats["forms"] == 0


def test_router_least_loaded_is_the_port_controlplane_class():
    """The sim LB and the real engine route with ONE implementation: the
    port's controlplane class, never a copy (the reference asserts the same
    sharing for its own packages)."""
    g = T.cluster.build_group(3, 2)
    lb = T.router.LoadBalancer(g)
    assert type(lb._least_loaded) is T.controlplane.LeastLoadedRouting
    assert T.router.LeastLoadedRouting is T.controlplane.LeastLoadedRouting
    # and it routes like the reference's LB, request for request
    lj = J.router.LoadBalancer(J.cluster.build_group(3, 2))
    for rid in range(9):
        rt = T.request.Request(rid=rid, prompt_len=8, max_new_tokens=2,
                               arrival_time=0.0)
        rj = J.request.Request(rid=rid, prompt_len=8, max_new_tokens=2,
                               arrival_time=0.0)
        lb.submit(rt)
        lj.submit(rj)
        assert rt.instance_id == rj.instance_id
        if rid == 4:    # instance 0 goes offline: traffic moves off it
            for L in (lb, lj):
                inst = L.group.instances[0]
                inst.state = type(inst.state)("offline")
                L.requeue(L.drain_instance(inst))
    assert [[r.rid for r in i.waiting] for i in lb.group.instances] == \
        [[r.rid for r in i.waiting] for i in lj.group.instances]
    assert lb.queue_depth() == lj.queue_depth() == 9


@pytest.mark.parametrize("policy", ["least_loaded", "round_robin"])
def test_router_policies_equal_reference(policy):
    lbs = [P.router.LoadBalancer(P.cluster.build_group(4, 1), policy=policy)
           for P in (J, T)]
    rng = np.random.default_rng(5)
    for rid in range(40):
        done = int(rng.integers(4)) if rid % 7 == 3 else None
        got = []
        for P, lb in zip((J, T), lbs):
            r = P.request.Request(rid=rid, prompt_len=8, max_new_tokens=2,
                                  arrival_time=0.0)
            lb.submit(r)
            got.append(r.instance_id)
            if done is not None and lb.group.instances[done].waiting:
                lb.group.instances[done].waiting.pop(0)   # one finishes
        assert got[0] == got[1]
    assert [len(i.waiting) for i in lbs[1].group.instances] == \
        [len(i.waiting) for i in lbs[0].group.instances]


# -- replication on real CPU pools: the copy goes into the hosted slot --------

POOL_KW = dict(n_layers=2, n_kv_heads=2, head_dim=8, dtype=torch.float32,
               device="cpu")


def _write_random(pool, refs, gen):
    slots = [r.slot for r in refs]
    shape = (2, 2, len(slots), pool.page_size, 8)
    pool.write_blocks(slots, torch.randn(shape, generator=gen),
                      torch.randn(shape, generator=gen))


def _page(pool, slot):
    return torch.stack(pool.read_block(slot)).clone()


def test_replication_copies_into_hosted_slot_on_real_pools():
    """Each block is copied into the slot the target reserved for it, not
    into the source's slot number: with the target's own request holding
    the slots the source uses, the hosted pages equal the primary pages bit
    for bit, the target's own pages keep their bytes, and a promoted
    replica after a failure reads the primary's bytes."""
    gen = torch.Generator().manual_seed(0)
    g = T.cluster.build_group(2, 2, kv_blocks_per_node=16, page_size=4,
                              real_pools=True, pool_kw=POOL_KW)
    mgr = T.replication.ReplicationManager(
        g, T.replication.ReplicationConfig(blocks_per_second=1000))
    node, target = g.instances[0].home_nodes[1], g.instances[1].home_nodes[1]
    assert node.kv_pool.real and node.kv_pool.k.device.type == "cpu"
    assert mgr.target_for(node) is target
    # the target's own live request, in slots 15-13 of its pool (it is
    # replicated the other way round, onto the node)
    own = target.kv_pool.allocate(100, 10)
    _write_random(target.kv_pool, own, gen)
    own_bytes = {r.slot: _page(target.kv_pool, r.slot) for r in own}
    refs = node.kv_pool.allocate(1, 10)
    _write_random(node.kv_pool, refs, gen)
    req = T.request.Request(rid=1, prompt_len=10, max_new_tokens=8,
                            arrival_time=0.0)
    # the source's slot numbers are the target's live slots: a copy into
    # the source's slot numbers would overwrite the target's own pages
    assert {r.slot for r in refs} == set(own_bytes)

    def check_replica():
        for src, dst, rid in ((node, target, 1), (target, node, 100)):
            hosted = dst.kv_pool.replica_table(src.node_id, rid)
            primary = src.kv_pool.table(rid)
            assert [h.logical_idx for h in hosted] == \
                [p.logical_idx for p in primary]
            for h, p in zip(hosted, primary):
                assert torch.equal(_page(dst.kv_pool, h.slot),
                                   _page(src.kv_pool, p.slot))
        for slot, want in own_bytes.items():
            assert torch.equal(_page(target.kv_pool, slot), want)

    mgr.tick(0.1, {1: req})
    assert req.replicated_through == 10 and req.replica_node == target.node_id
    check_replica()
    # decode: tokens fill page 2 and open page 3; rewrite both pages
    for _ in range(4):
        node.kv_pool.append_token(1)
    _write_random(node.kv_pool, node.kv_pool.table(1)[2:], gen)
    mgr.tick(0.1, {1: req})
    assert req.replicated_through == 14
    assert mgr.stats["blocks_replicated"] == 3 + 3 + 2
    check_replica()
    primary = {p.logical_idx: _page(node.kv_pool, p.slot)
               for p in node.kv_pool.table(1)}
    node.fail()
    resumed_on = mgr.target_for_failed(node)
    assert resumed_on is target
    promoted = mgr.promote(node.node_id, resumed_on, 1)
    assert [r.logical_idx for r in promoted] == [0, 1, 2, 3]
    for r in promoted:
        assert torch.equal(_page(target.kv_pool, r.slot),
                           primary[r.logical_idx])
    for slot, want in own_bytes.items():
        assert torch.equal(_page(target.kv_pool, slot), want)


def test_replication_under_pressure_promotes_only_primary_bytes():
    """A target too small for both replicas: its own request holds 5 of
    its 8 pages, so when the source's request grows to a 4th page the
    target evicts that request's replica and re-hosts it from logical 0.
    Every hosted page must then hold the primary's bytes, the target's own
    pages keep theirs, ``replicated_through`` counts only tokens on hosted
    pages, and after a failure the promoted replica reads the primary's
    bytes for exactly those tokens."""
    gen = torch.Generator().manual_seed(1)
    g = T.cluster.build_group(3, 2, kv_blocks_per_node=8, page_size=4,
                              real_pools=True, pool_kw=POOL_KW)
    mgr = T.replication.ReplicationManager(
        g, T.replication.ReplicationConfig(blocks_per_second=1000))
    node, target = g.instances[0].home_nodes[1], g.instances[1].home_nodes[1]
    assert mgr.target_for(node) is target
    own = target.kv_pool.allocate(100, 20)
    _write_random(target.kv_pool, own, gen)
    own_bytes = {r.slot: _page(target.kv_pool, r.slot) for r in own}
    refs = node.kv_pool.allocate(1, 10)
    _write_random(node.kv_pool, refs, gen)
    req = T.request.Request(rid=1, prompt_len=10, max_new_tokens=8,
                            arrival_time=0.0)

    def check_replica():
        hosted = target.kv_pool.replica_table(node.node_id, 1)
        primary = {p.logical_idx: p for p in node.kv_pool.table(1)}
        for h in hosted:
            assert torch.equal(_page(target.kv_pool, h.slot),
                               _page(node.kv_pool,
                                     primary[h.logical_idx].slot))
        on_hosted = {h.logical_idx for h in hosted}
        assert req.replicated_through == sum(
            p.n_filled for i, p in primary.items() if i in on_hosted)
        assert all(not p.replicated for i, p in primary.items()
                   if i not in on_hosted)
        for slot, want in own_bytes.items():
            assert torch.equal(_page(target.kv_pool, slot), want)
        return sorted(on_hosted)

    mgr.tick(0.1, {1: req})
    assert target.kv_pool.n_free == 0 and check_replica() == [0, 1, 2]
    assert req.replicated_through == 10
    # decode opens a 4th page: the full target evicts this very replica
    for _ in range(3):
        node.kv_pool.append_token(1)
    _write_random(node.kv_pool, node.kv_pool.table(1)[2:], gen)
    mgr.tick(0.1, {1: req})
    assert check_replica() == [0] and req.replicated_through == 4
    # the next tick re-hosts as much as fits (3 of the 4 pages)
    mgr.tick(0.1, {1: req})
    assert check_replica() == [0, 1, 2] and req.replicated_through == 12
    # the target's own 5 pages went to the third instance; the source's
    # blocks counted once each, and none without a hosted page
    assert mgr.stats["blocks_replicated"] == 5 + 3 + 0 + 2
    primary = {p.logical_idx: _page(node.kv_pool, p.slot)
               for p in node.kv_pool.table(1)}
    node.fail()
    promoted = mgr.promote(node.node_id, mgr.target_for_failed(node), 1)
    assert [r.logical_idx for r in promoted] == [0, 1, 2]
    for r in promoted:
        assert torch.equal(_page(target.kv_pool, r.slot),
                           primary[r.logical_idx])
    for slot, want in own_bytes.items():
        assert torch.equal(_page(target.kv_pool, slot), want)


# -- recovery on real CPU pools ------------------------------------------------

def _recovery(pkg):
    return importlib.import_module(f"{pkg}.core.recovery")


@pytest.mark.parametrize("mode", ["kevlarflow", "standard"])
def test_replacement_node_gets_a_real_pool_like_its_template(mode):
    """Node 1 (instance 0, stage 1) of a real-pool group fails and is
    replaced: in the background (kevlarflow, ``_complete_replacement``) or
    when its instance comes back (standard, ``_complete_offline_return``).
    The new node's pool is real, with the template's geometry, dtype and
    device; one tick copies bytes both ways, with the new node as source
    and as target; and after the new node fails, its promoted replica
    holds the primary's K/V bit for bit."""
    gen = torch.Generator().manual_seed(2)
    g = T.cluster.build_group(2, 2, kv_blocks_per_node=16, page_size=4,
                              real_pools=True, pool_kw=POOL_KW)
    mgr = T.replication.ReplicationManager(
        g, T.replication.ReplicationConfig(blocks_per_second=1000))
    rec = _recovery("repro_torch").RecoveryOrchestrator(
        g, T.communicator.CommunicatorManager(), T.router.LoadBalancer(g),
        mgr, mode=mode)
    old, peer = g.nodes[1], g.nodes[3]
    template = old.kv_pool
    old.fail()
    rec.on_node_failure_detected(old.node_id, 0.0)
    rec.tick(1e6)                    # past the re-form and the full re-init
    new = g.instances[0].home_nodes[1]
    assert new is not old and g.instances[0].stage_nodes[1] is new
    pool = new.kv_pool
    assert pool.real and not pool.quantized
    assert pool.k.shape == template.k.shape and pool.k.dtype == torch.float32
    assert pool.k.device.type == "cpu" and pool.n_free == 16
    assert mgr.target_for(new) is peer and mgr.target_for(peer) is new
    reqs = {}
    for node, rid in ((new, 1), (peer, 2)):
        _write_random(node.kv_pool, node.kv_pool.allocate(rid, 8), gen)
        reqs[rid] = T.request.Request(rid=rid, prompt_len=8,
                                      max_new_tokens=4, arrival_time=0.0)
    mgr.tick(0.1, reqs)
    for src, dst, rid in ((new, peer, 1), (peer, new, 2)):
        hosted = dst.kv_pool.replica_table(src.node_id, rid)
        primary = src.kv_pool.table(rid)
        assert len(hosted) == 2 and reqs[rid].replicated_through == 8
        for h, p in zip(hosted, primary):
            assert torch.equal(_page(dst.kv_pool, h.slot),
                               _page(src.kv_pool, p.slot))
    want = [_page(pool, p.slot) for p in pool.table(1)]
    new.fail()
    promoted = mgr.promote(new.node_id, mgr.target_for_failed(new), 1)
    assert [r.logical_idx for r in promoted] == [0, 1]
    for r, page in zip(promoted, want):
        assert torch.equal(_page(peer.kv_pool, r.slot), page)


@pytest.mark.parametrize("real", [True, False])
def test_evicted_replica_is_no_longer_counted_by_its_source(real):
    """The target of a replicated 10-token request evicts that replica for
    its own 24-token request, and the source fails before the next tick.
    On real pools the source's blocks lose their flags at the eviction,
    ``replicated_through`` drops to 0, and the re-form resumes the request
    partially with nothing promoted (never a "seamless" resume with an
    empty replica table). Metadata pools keep the reference's behaviour,
    stats for stats with it."""
    stats = []
    for pkg in (("repro_torch",) if real else PACKAGES):
        P = _load(pkg)
        g = P.cluster.build_group(2, 2, kv_blocks_per_node=8, page_size=4,
                                  real_pools=real,
                                  pool_kw=POOL_KW if real else None)
        mgr = P.replication.ReplicationManager(
            g, P.replication.ReplicationConfig(blocks_per_second=1000))
        rec = _recovery(pkg).RecoveryOrchestrator(
            g, P.communicator.CommunicatorManager(), P.router.LoadBalancer(g),
            mgr, mode="kevlarflow")
        node, target = g.nodes[1], g.nodes[3]
        node.kv_pool.allocate(1, 10)
        req = P.request.Request(rid=1, prompt_len=10, max_new_tokens=8,
                                arrival_time=0.0)
        req.state = P.request.RequestState.DECODE
        req.instance_id = 0
        g.instances[0].running.append(req)
        mgr.tick(0.1, {1: req})
        assert req.replicated_through == 10
        assert len(target.kv_pool.replica_table(node.node_id, 1)) == 3
        need = target.kv_pool.blocks_for_tokens(24)
        assert target.kv_pool.evict_replicas_for_pressure(need) == 3
        target.kv_pool.allocate(100, 24)
        assert target.kv_pool.replica_table(node.node_id, 1) == []
        flags = [b.replicated for b in node.kv_pool.table(1)]
        if real:
            assert req.replicated_through == 0 and not any(flags)
        else:
            assert req.replicated_through == 10 and all(flags)
        node.fail()
        rec.on_node_failure_detected(node.node_id, 0.0)
        rec.tick(rec._reforms[0].done_at)
        assert req.state == P.request.RequestState.MIGRATING
        assert 1 not in target.kv_pool.live_requests()   # nothing promoted
        stats.append(dict(rec.stats))
    if real:
        assert stats[0]["seamless_resumes"] == 0
        assert stats[0]["partial_resumes"] == 1
    else:
        assert stats[0] == stats[1] and stats[0]["seamless_resumes"] == 1
