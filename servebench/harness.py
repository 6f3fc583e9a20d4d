"""One run of one cell: set-up, the measured window, the check, the result.

The window drives the port's service layer in-process
(``repro_torch.serving.server.EngineService``): ``submit`` and the
``Request`` handles it returns, and ``apply_fault`` for a kill. An open loop
sends on its schedule for the window and then waits (up to the traffic's
grace) until every request due in the window has finished; one that has not
by then failed. A closed loop's clients each send their next request when
the last one completes, until the window closes; requests still decoding
then are neither counted nor failed.

Everything the metrics read is gathered into one ``Record``; each metric's
own file computes its number from it. Right after the close the replicas
are read back against their primaries (``check.read_back_replicas``); the
rest of the check that decides ``correct`` runs after the service is shut
down (``check.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from servebench import check as CHECK
from servebench import workload as W
from servebench.bench import Cell
from servebench.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
POLL_S = 0.005


@dataclasses.dataclass
class Record:
    """What a run leaves for the metrics to read. Times are host-clock
    seconds (``time.time``), the engine's clock."""
    cell: str
    model: dict
    traffic: dict
    setup_s: float
    t_open: float
    t_close: float
    t_stop: float
    requests: List[dict]          # one per request sent in the window
    steps: List[tuple]            # step_samples appended inside the window
    repl_bytes: int               # replicated bytes shipped in the window
    failure_events: List[dict]
    trace: Optional[dict] = None  # Tracer.summary() plus the edge snapshots
    device_name: str = ""
    replicas: Optional[dict] = None   # check.read_back_replicas after the close


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN and sys.modules[m] is not None)


def port_config(config: dict):
    """The port's ModelConfig of a configuration file: its named config with
    every field that the file's ``model`` block states replaced by it."""
    from repro_torch.configs import get_config
    base = get_config(config["port_config"])
    fields = {f.name for f in dataclasses.fields(base)}
    return dataclasses.replace(
        base, **{k: v for k, v in config["model"].items() if k in fields})


def engine_config(config: dict, traffic: dict):
    """EngineConfig of the configuration file, plus the kill's rejoin."""
    from repro_torch.serving.engine import EngineConfig
    fields = dict(config["engine"])
    kill = traffic.get("kill")
    if kill:
        fields["auto_rejoin"] = True
        fields["rejoin_delay"] = float(kill["rejoin_delay_s"])
    return EngineConfig(**fields)


class Handles:
    """The requests the window sent, with their due times."""

    def __init__(self):
        self.items: List[tuple] = []        # (due, planned, Request)
        self.lock = threading.Lock()

    def add(self, due, planned, req):
        with self.lock:
            self.items.append((due, planned, req))

    def all(self) -> List[tuple]:
        with self.lock:
            return list(self.items)


def _snapshot_generated(handles: Handles) -> Dict[int, tuple]:
    return {req.rid: (req.prompt_len, req.generated)
            for _, _, req in handles.all()}


def _warm_up(svc, traffic: dict, cfg, seed: int):
    """Every prefill shape the traffic can reach (one prompt per bucket) and
    the decode step (always the full slot count), through the service."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    reqs = [svc.submit(rng.integers(1, cfg.vocab_size, n).tolist(), 3)
            for n in W.warmup_prompt_lengths(traffic, cfg.page_size)]
    for r in reqs:
        if not svc.wait(r, timeout=600):
            raise RuntimeError("warm-up request did not complete")


def _open_loop(svc, plan, t_open, seconds, handles, actions):
    """Send each planned request when it is due, and run each timed action
    (a kill, a profile edge) at its time, from this thread."""
    events = [(t_open + p.due, 1, p) for p in plan] + \
        [(at, 0, fn) for at, fn in actions]
    events.sort(key=lambda e: (e[0], e[1]))
    for at, kind, item in events:
        delay = at - time.time()
        if delay > 0:
            time.sleep(delay)
        if kind == 0:
            item()
        else:
            handles.add(at, item, svc.submit(item.prompt, item.max_new))
    rest = t_open + seconds - time.time()
    if rest > 0:
        time.sleep(rest)


def _closed_loop(svc, plan, traffic, t_open, seconds, handles, actions):
    """Each client sends its next request when its last one completed (the
    first sends staggered), until the window closes; timed actions run when
    their time has come."""
    clients = int(traffic["clients"])
    stagger = float(traffic.get("stagger_s", 0.0))
    pool = iter(plan)
    t_close = t_open + seconds
    nxt = [t_open + stagger * c / clients for c in range(clients)]
    current: List = [None] * clients
    todo = sorted(actions, key=lambda a: a[0])
    while True:
        now = time.time()
        if now >= t_close:
            return
        while todo and todo[0][0] <= now:
            todo.pop(0)[1]()
        for c in range(clients):
            req = current[c]
            if req is not None and req.finish_time >= 0:
                current[c], nxt[c] = None, now
            if current[c] is None and nxt[c] is not None and now >= nxt[c]:
                p = next(pool, None)
                if p is None:
                    raise RuntimeError("the closed loop ran out of requests: "
                                       "raise the traffic's 'requests'")
                current[c] = svc.submit(p.prompt, p.max_new)
                handles.add(now, p, current[c])
                nxt[c] = None
        if svc.error is not None:
            raise RuntimeError("engine loop stopped") from svc.error
        time.sleep(POLL_S)


def _kill(svc, traffic):
    from repro_torch.serving.api_types import FaultSpec
    kill = traffic["kill"]
    return svc.apply_fault(FaultSpec(granularity="instance",
                                     instance_id=int(kill["instance"])))


def _read_back(svc, handles, until: float) -> dict:
    """The replicas read back (``check.read_back_replicas``) between two
    engine steps, first right after the close; again every 50 ms while no
    request is decoding but some are unfinished, until ``until``."""
    while True:
        if svc.error is not None:
            raise RuntimeError("engine loop stopped") from svc.error
        with svc._lock:
            found = CHECK.read_back_replicas(svc.engine)
        live = any(req.finish_time < 0 for _, _, req in handles.all())
        if found["compared"] or not live or time.time() >= until:
            return found
        time.sleep(0.05)


def _grace(svc, handles, t_open, t_close, grace_s):
    """Keep stepping until every request due in the window has finished, at
    most ``grace_s`` past the close."""
    deadline = t_close + grace_s
    while time.time() < deadline:
        if svc.error is not None:
            raise RuntimeError("engine loop stopped") from svc.error
        if all(req.finish_time >= 0 for d, _, req in handles.all()
               if t_open <= d < t_close):
            return
        time.sleep(0.05)


class _ProfileEdges(threading.Thread):
    """Opens the traced sub-window at ``start`` and closes it ``length``
    seconds after it actually opened (or when ``closed`` is set at the
    window's close), each edge taken under the service's lock, so between
    two engine steps. The profiler has to start and stop in one thread, so
    this thread also stops it, right after the end edge. ``stopped`` is set
    once the end edge is taken (or no window was opened)."""

    def __init__(self, svc, tracer, snapshot, start: float, length: float):
        super().__init__(daemon=True)
        self.svc, self.tracer, self.snapshot = svc, tracer, snapshot
        self.start_at, self.length = start, length
        self.closed = threading.Event()
        self.stopped = threading.Event()
        self.error = None

    def run(self):
        try:
            if self.closed.wait(max(0.0, self.start_at - time.time())):
                return
            with self.svc._lock:
                self.tracer.start(self.snapshot())
                opened = time.time()
            self.closed.wait(max(0.0, opened + self.length - time.time()))
            with self.svc._lock:
                self.tracer.stop(self.snapshot())
            self.stopped.set()
            # outside the lock, so the stop's processing holds the engine
            # only as long as it holds the interpreter
            self.tracer.finish()
        except Exception as e:  # noqa: BLE001 — re-raised by the run
            self.error = e
        finally:
            self.stopped.set()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda",
             check_fn: Callable = CHECK.check) -> dict:
    """Run ``cell`` once and return its result line (a dict). ``device`` is
    the card in a real run; the tests drive the same path on the CPU."""
    import torch
    from repro_torch.serving.server import EngineService
    from servebench import weights as WT

    config, traffic = cell.config, cell.traffic
    model = config["model"]
    cfg = port_config(config)
    ecfg = engine_config(config, traffic)
    params = WT.draw(model, seed, device)
    svc = EngineService(cfg, ecfg, n_instances=int(config["n_instances"]),
                        device=device, params=params)
    tracer = edges = None
    try:
        _warm_up(svc, traffic, cfg, seed)
        plan = W.plan(traffic, seed, seconds, cfg.vocab_size)
        handles = Handles()
        eng = svc.engine
        if trace:
            tracer = Tracer(profile_device=device == "cuda")
            tracer.warm_up()
            tracer.install()
        if device == "cuda":
            torch.cuda.synchronize()
        with svc._lock:
            steps_open = len(eng.step_samples)
            repl_open = eng.replication_stats()["bytes_total"]
        t_open = time.time()
        setup_s = t_open - t_start
        actions = []
        if traffic.get("kill"):
            actions.append((t_open + traffic["kill"]["at_frac"] * seconds,
                            lambda: _kill(svc, traffic)))
        if tracer is not None:
            # the window's last seconds: the profiler's stop holds the
            # interpreter for seconds, and there it holds no measured step
            length = min(float(traffic.get("profile_s", 5.0)), seconds)
            edges = _ProfileEdges(
                svc, tracer,
                lambda: {"steps": len(eng.step_samples),
                         "gen": _snapshot_generated(handles)},
                t_open + seconds - length, length)
            edges.start()
        if traffic["loop"] == "open":
            _open_loop(svc, plan, t_open, seconds, handles, actions)
        else:
            _closed_loop(svc, plan, traffic, t_open, seconds, handles,
                         actions)
        if edges is not None:
            edges.closed.set()
        with svc._lock:
            t_close = time.time()
            gen_close = {req.rid: req.generated for _, _, req in handles.all()}
            steps_close = len(eng.step_samples)
            repl_close = eng.replication_stats()["bytes_total"]
        if edges is not None:
            # the read-back's copies and compares stay out of the profile
            edges.stopped.wait()
        replicas = _read_back(svc, handles,
                              t_close + float(traffic.get("grace_s", 30.0)))
        if traffic["loop"] == "open":
            _grace(svc, handles, t_open, t_close,
                   float(traffic.get("grace_s", 30.0)))
        with svc._lock:
            t_stop = time.time()
            requests = [{
                "rid": req.rid, "due": due, "prompt_len": req.prompt_len,
                "max_new": req.max_new_tokens, "admit": req.admit_time,
                "first": req.first_token_time, "finish": req.finish_time,
                "generated": req.generated, "gen_open": 0,
                "gen_close": gen_close[req.rid],
                "migrations": req.n_migrations, "retries": req.n_retries,
                "state": req.state.value, "prompt": p.prompt,
                "output": list(req.output_tokens or []),
            } for due, p, req in handles.all()]
            steps = list(eng.step_samples[steps_open:steps_close])
            failure_events = [dict(e) for e in eng.failure_events]
        svc.shutdown()
        if svc.error is not None:
            raise RuntimeError("engine loop stopped") from svc.error
    finally:
        if tracer is not None:
            tracer.uninstall()
        if edges is not None:
            edges.closed.set()
            edges.join()
        svc.shutdown()          # again after an error; a stopped loop returns
    if edges is not None and edges.error is not None:
        raise edges.error
    summary = tracer.summary() if tracer is not None else None
    if summary is not None:
        summary["edges"] = tracer.edges
        print(f"servebench: profiler stop took {summary['stop_s']:.3f} s",
              file=sys.stderr)
    elif tracer is not None and device == "cuda":
        print(f"servebench: no device profile (state {tracer.state}, "
              f"{getattr(tracer, 'n_device_events', 0)} device events)",
              file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    name = torch.cuda.get_device_name() if device == "cuda" else "cpu"
    record = Record(
        cell=cell.name, model=model, traffic=traffic, setup_s=setup_s, t_open=t_open, t_close=t_close,
        t_stop=t_stop, requests=requests, steps=steps,
        repl_bytes=repl_close - repl_open, failure_events=failure_events,
        trace=summary, device_name=name, replicas=replicas)
    # the service's pools go before the reference runs
    del svc, eng
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if m.source == "device_trace" and device != "cuda":
            continue            # no device number from a run off the card
        value = m.compute(record)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    checks = check_fn(config, model, params, record, seed)
    correct = all(c["ok"] for c in checks.values())
    due = [r for r in record.requests if t_open <= r["due"] < t_close]
    failed = sum(1 for r in due if r["finish"] < 0) \
        if traffic["loop"] == "open" else 0
    result = {
        "correct": correct,
        "attempted": len(due),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": name,
                   "count": 1 if device == "cuda" else 0,
                   "memory_peak_bytes": memory_peak},
    }
    if trace and summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {
            "device_ops": [[n[:160], t] for n, t in summary["device_ops"]],
            "idle_gaps": [[n, t] for n, t in summary["idle_gaps"]]}
    result["checks"] = {k: {kk: vv for kk, vv in c.items() if kk != "ok"}
                        for k, c in checks.items()}
    return result
