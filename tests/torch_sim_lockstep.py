"""Lockstep runs of the port's simulated system against the reference's
(imported by the ``test_torch_system*`` files; not a test file itself).

Both systems get the same arguments, the same seeded ``poisson_workload``
(each package's own) and the same failures, and step together. Every few
steps the instance states and pipelines, every request's state and
timestamps, every node's free block count and the recovery, replication
and communicator stats are compared; every few hundred steps and at the
end every pool's block tables and hosted replicas too. At the end
``metrics()`` and ``mttr_events()`` are compared with ``==``: the
simulation is plain Python over metadata pools, so equal seeds must give
equal floats, not close ones."""
import numpy as np

from repro.core import system as JS
from repro.serving import workload as JW
from repro_torch.core import system as TS
from repro_torch.serving import workload as TW

DT = 0.1


def _ids(nodes):
    return [None if n is None else n.node_id for n in nodes]


def _light(s):
    return {
        "t": s.clock.now(),
        "instances": [(i.state.value, _ids(i.stage_nodes),
                       _ids(i.home_nodes), i.recovering_until,
                       i.offline_until, [r.rid for r in i.running],
                       [r.rid for r in i.waiting])
                      for i in s.group.instances],
        "nodes": [(n.node_id, n.home_instance, n.state.value, list(n.roles),
                   n.kv_pool.n_free) for n in s.group.nodes],
        "requests": {rid: (r.state.value, r.generated, r.instance_id,
                           r.admit_time, r.first_token_time, r.finish_time,
                           r.n_retries, r.n_migrations, r.prefill_progress,
                           r.replicated_through, r.replica_node,
                           r.migrate_pause)
                     for rid, r in s.requests.items()},
        "progress": dict(s._progress),
        "recovery": dict(s.recovery.stats),
        "replication": dict(s.replication.stats),
        "carry": dict(s.replication._budget_carry),
        "comms": dict(s.comms.stats),
        "events": [(e.at, e.node_id, e.detected_at, e.recovered_at,
                    e.replaced_at) for e in s.injector.events],
        "queue_depth": s.router.queue_depth(),
        "capacity": s.group.total_capacity(),
    }


def _full(s):
    out = _light(s)
    out["pools"] = [
        (n.node_id, list(n.kv_pool._free),
         {rid: [(b.logical_idx, b.slot, b.n_filled, b.replicated)
                for b in n.kv_pool.table(rid)]
          for rid in n.kv_pool.live_requests()},
         {k: [(b.logical_idx, b.slot, b.n_filled) for b in v]
          for k, v in n.kv_pool._replica_tables.items()})
        for n in s.group.nodes]
    return out


def _final(s):
    return {"metrics": s.metrics(),
            "mttr": [(e.at, e.node_id, e.detected_at, e.recovered_at,
                      e.replaced_at, e.mttr) for e in s.mttr_events()],
            "state": _full(s)}


def lockstep(n, mode, rps, arrive, horizon, fails=(), seed=1, storm=None,
             every=25, full_every=500, **sys_kw):
    """Run both systems side by side; ``storm`` = (rng seed, number of
    failures, window) draws failure times and healthy victims as
    ``tests/test_failure_storm.py`` does. Returns (reference, port)."""
    sj = JS.ServingSystem(n_instances=n, mode=mode, **sys_kw)
    st = TS.ServingSystem(n_instances=n, mode=mode, **sys_kw)
    wj = sorted(JW.poisson_workload(rps, arrive, seed=seed),
                key=lambda r: r.arrival_time)
    wt = sorted(TW.poisson_workload(rps, arrive, seed=seed),
                key=lambda r: r.arrival_time)
    assert [(r.rid, r.prompt_len, r.max_new_tokens, r.arrival_time)
            for r in wt] == [(r.rid, r.prompt_len, r.max_new_tokens,
                              r.arrival_time) for r in wj]
    for at, nid in fails:
        sj.inject_failure(at, nid)
        st.inject_failure(at, nid)
    scheduled, rng = [], None
    if storm is not None:
        rng = np.random.default_rng(storm[0])
        scheduled = list(np.sort(rng.uniform(*storm[2], storm[1])))
    idx = steps = 0
    assert _full(st) == _full(sj)
    while st.clock.now() < horizon:
        now = st.clock.now()
        assert sj.clock.now() == now
        while idx < len(wt) and wt[idx].arrival_time <= now:
            sj.submit(wj[idx])
            st.submit(wt[idx])
            idx += 1
        if scheduled and scheduled[0] <= now:
            scheduled.pop(0)
            healthy = [nd.node_id for nd in st.group.nodes
                       if nd.state.value == "healthy"]
            assert healthy == [nd.node_id for nd in sj.group.nodes
                               if nd.state.value == "healthy"]
            if healthy:
                victim = healthy[rng.integers(len(healthy))]
                sj.inject_failure(at=now, node_id=victim)
                st.inject_failure(at=now, node_id=victim)
        sj.step(DT)
        st.step(DT)
        steps += 1
        if steps % full_every == 0:
            assert _full(st) == _full(sj), f"diverged by t={now}"
        elif steps % every == 0:
            assert _light(st) == _light(sj), f"diverged by t={now}"
    assert _final(st) == _final(sj)
    return sj, st
