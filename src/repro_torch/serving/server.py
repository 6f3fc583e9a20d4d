"""OpenAI-compatible HTTP front-end (paper Sec 3.3: "providing an OpenAI-
compatible server endpoint"): a threaded stdlib HTTP server over RealEngine
with a background engine loop, POST /v1/completions, GET /health, and the
versioned fault-injection admin API (``POST /v1/admin/fault`` /
``POST /v1/admin/recover``; the legacy ``/admin/fail_instance`` /
``/admin/rejoin_instance`` paths remain as deprecated aliases).

  PYTHONPATH=src python -m repro_torch.serving.server --arch llama3-8b --port 8080
  curl -d '{"prompt_tokens": [1,2,3], "max_tokens": 8}' localhost:8080/v1/completions

The model runs at the config's full size on the card (``--device cuda``,
the default); ``--device cpu --reduced`` serves the reduced config on the
CPU. ``--kv-quant`` serves from an int8 KV pool and ``--prefill-chunk N``
runs prompts in chunks of N tokens interleaved with decode steps.
``--prefix-cache`` shares fully-covered prompt pages between requests by
reference, and ``--disaggregate`` splits the instances into prefill and
decode roles (chunked prefill, 8 tokens a chunk unless ``--prefill-chunk``
says otherwise). ``--n-shards`` sets the tensor-parallel shards per
instance: ``POST /v1/admin/fault`` with ``granularity="shard"`` degrades an
instance onto its surviving shards (``/health`` shows ``lost_shards``, the
capped ``slot_cap`` and the degraded ``layout``), and ``POST
/v1/admin/recover`` with ``granularity="shard"`` restores it. The flags
combine freely.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.serving.api_types import (DegradationState, FaultSpec,
                                           HealthResponse, InstanceStatus,
                                           TopologyBlock)
from repro_torch.serving.engine import EngineConfig, RealEngine
from repro_torch.serving.request import Request


class EngineService:
    """Background continuous-batching loop around RealEngine.

    The engine runs on the WALL clock (``clock=time.time``), so request
    timestamps — arrival, admit, first token, completion — live on one
    timebase and the HTTP layer reports real TTFT/latency seconds."""

    def __init__(self, cfg, ecfg: EngineConfig, n_instances: int = 2,
                 device="cuda", params=None):
        self.engine = RealEngine(cfg, ecfg, n_instances=n_instances,
                                 clock=time.time, device=device,
                                 params=params)
        self.cfg = cfg
        self._lock = threading.Lock()
        self._next_rid = 0
        self._events: dict[int, threading.Event] = {}
        self._n_signaled = 0            # engine.done prefix already signaled
        self._stop = False
        self.error = None               # exception that stopped the loop
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        try:
            while not self._stop:
                progressed = 0
                with self._lock:
                    if self.engine.has_pending() or \
                            self.engine.recovery_pending():
                        progressed = self.engine.step()
                    new_done = self.engine.done[self._n_signaled:]
                    self._n_signaled = len(self.engine.done)
                for req in new_done:
                    ev = self._events.get(req.rid)
                    if ev:
                        ev.set()
                if progressed:
                    # threading.Lock is not fair: without a pause this loop
                    # re-takes the lock before a waiting HTTP thread wakes,
                    # and submit/health/fault calls stall for seconds
                    time.sleep(0.0002)
                else:
                    busy = self.engine.has_pending()
                    time.sleep(0.002 if busy else 0.01)
        except Exception as e:  # noqa: BLE001 — reported to every waiter
            # a failed step (e.g. a kernel launch error) must not leave
            # clients waiting forever: record it and wake every waiter
            self.error = e
            for ev in list(self._events.values()):
                ev.set()
            raise

    def submit(self, prompt_tokens, max_tokens: int) -> Request:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            req = Request(rid=rid, prompt_len=len(prompt_tokens),
                          max_new_tokens=max_tokens, arrival_time=time.time(),
                          prompt_tokens=list(prompt_tokens))
            self._events[rid] = threading.Event()
            self.engine.submit(req)
        return req

    def wait(self, req: Request, timeout: float = 120.0) -> bool:
        """True once ``req`` completed; raises if the engine loop died."""
        done = self._events[req.rid].wait(timeout)
        if self.error is not None:
            raise RuntimeError("engine loop stopped") from self.error
        return done

    def drain(self, timeout: float = 300.0) -> bool:
        """Block until every submitted request has completed."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if not self.engine.has_pending():
                    return True
            time.sleep(0.005)
        return False

    # -- fault/admin entry points (versioned API's service layer) -------------
    def apply_fault(self, spec: FaultSpec):
        """One lock-held engine call per fault; ``spec.if_busy`` is atomic
        with the fault itself (same lock)."""
        with self._lock:
            return self.engine.apply_fault(spec)

    def recover(self, spec: FaultSpec):
        with self._lock:
            return self.engine.recover(spec)

    def validate_spec(self, spec: FaultSpec, for_recover: bool = False):
        """Shape-check a spec without applying it — malformed specs 400
        while state conflicts 409."""
        spec.validate(len(self.engine.instances), self.engine.ecfg.n_shards,
                      for_recover=for_recover)

    def fail_instance(self, instance_id: int):
        return self.apply_fault(
            FaultSpec(granularity="instance", instance_id=instance_id))

    def fail_instance_if_busy(self, instance_id: int):
        """Kill the instance IFF it has in-flight requests. Returns the
        resumed rids, or None if it was idle."""
        return self.apply_fault(
            FaultSpec(granularity="instance", instance_id=instance_id,
                      if_busy=True))

    def rejoin_instance(self, instance_id: int):
        self.recover(
            FaultSpec(granularity="instance", instance_id=instance_id))

    def health(self) -> HealthResponse:
        """The /health payload as its typed schema, built under the engine
        lock so every block is one consistent snapshot."""
        with self._lock:
            eng = self.engine
            instances = [
                InstanceStatus(
                    id=i.instance_id, alive=i.alive, role=i.role,
                    active=len(i.requests),
                    queued=len(eng.queues[i.instance_id]),
                    prefilling=i.prefill_depth(),
                    handoffs_ready=len(i.ready_handoffs),
                    pool_used_blocks=i.pool.n_used,
                    pool_replica_blocks=i.pool.replica_blocks_used(),
                    degradation=DegradationState(
                        state=eng.control.view.state_of(i.instance_id),
                        n_shards=i.n_shards,
                        lost_shards=sorted(i.lost_shards),
                        slot_cap=i.slot_cap if i.alive else 0,
                        capacity_frac=i.capacity_frac(),
                        layout=i.degraded_layout))
                for i in eng.instances]
            return HealthResponse(
                status="ok", instances=instances,
                queued=eng.queue_depth(), completed=len(eng.done),
                recovery_mode=eng.ecfg.recovery,
                failure_events=[dict(e) for e in eng.failure_events],
                replication=eng.replication_stats(),
                prefix=eng.prefix_stats(),
                disagg=eng.disagg_stats(),
                topology=TopologyBlock(**eng.control.describe()))

    def stats(self):
        """The /health payload as a plain dict."""
        return self.health().to_json()

    def shutdown(self, drain_timeout: float = 0.0):
        """Stop the engine loop; with ``drain_timeout`` > 0, let in-flight
        generations finish first and say what was abandoned on timeout."""
        if drain_timeout > 0 and not self.drain(timeout=drain_timeout):
            with self._lock:
                eng = self.engine
                unfinished = eng.queue_depth() + \
                    sum(len(i.requests) for i in eng.instances)
                parked = len(eng._handoffs)
            print(f"shutdown: drain timed out after {drain_timeout:.0f}s — "
                  f"{unfinished} request(s) unfinished, "
                  f"{parked} handoff(s) parked")
        self._stop = True
        self._thread.join(timeout=10)


def make_handler(svc: EngineService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj, headers=None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, svc.health().to_json())
            else:
                self._json(404, {"error": "not found"})

        def _fault(self, payload):
            """POST /v1/admin/fault. Shape errors (a spec out of range) are
            400; state conflicts (a shard fault on a dead instance) are
            409."""
            try:
                spec = FaultSpec.from_json(payload)
                svc.validate_spec(spec)
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            try:
                resumed = svc.apply_fault(spec)
            except ValueError as e:
                self._json(409, {"error": str(e)})
                return
            self._json(200, {
                "applied": resumed is not None,
                "fault": spec.to_json(),
                "seamlessly_resumed": resumed if resumed is not None else [],
            })

        def _recover(self, payload):
            """POST /v1/admin/recover. Shape errors are 400; state
            conflicts (rejoining an alive instance, restoring one that lost
            no shard) are 409."""
            try:
                spec = FaultSpec.from_json(payload)
                svc.validate_spec(spec, for_recover=True)
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            try:
                svc.recover(spec)
            except ValueError as e:
                self._json(409, {"error": str(e)})
                return
            self._json(200, {"recovered": spec.to_json()})

        def _completion(self, payload):
            toks = payload.get("prompt_tokens")
            if not toks:
                self._json(400, {"error": "prompt_tokens required"})
                return
            max_tokens = int(payload.get("max_tokens", 16))
            req = svc.submit(toks, max_tokens)
            try:
                done = svc.wait(req)
            except RuntimeError as e:
                self._json(500, {"error": f"{e}: {e.__cause__!r}"})
                return
            if not done:
                self._json(504, {"error": "timeout"})
                return
            self._json(200, {
                "id": f"cmpl-{req.rid}",
                "object": "text_completion",
                "model": svc.cfg.name,
                "choices": [{
                    "index": 0,
                    "token_ids": req.output_tokens,
                    "finish_reason": "length",
                }],
                "usage": {
                    "prompt_tokens": req.prompt_len,
                    "completion_tokens": len(req.output_tokens or []),
                },
                "timing": req.timing(),
                "kevlarflow": {"migrations": req.n_migrations,
                               "retries": req.n_retries},
            })

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._json(400, {"error": "bad json"})
                return
            if self.path == "/v1/completions":
                self._completion(payload)
            elif self.path == "/v1/admin/fault":
                self._fault(payload)
            elif self.path == "/v1/admin/recover":
                self._recover(payload)
            # deprecated aliases: same engine transition as the v1 pair
            # (instance granularity), legacy bodies, Deprecation header
            elif self.path == "/admin/fail_instance":
                iid = int(payload.get("instance", 0))
                resumed = svc.fail_instance(iid)
                self._json(200, {"failed_instance": iid,
                                 "seamlessly_resumed": resumed},
                           headers={"Deprecation": "true"})
            elif self.path == "/admin/rejoin_instance":
                iid = int(payload.get("instance", 0))
                try:
                    svc.rejoin_instance(iid)
                except ValueError as e:
                    self._json(409, {"error": str(e)},
                               headers={"Deprecation": "true"})
                    return
                self._json(200, {"rejoined_instance": iid},
                           headers={"Deprecation": "true"})
            else:
                self._json(404, {"error": "not found"})

    return Handler


def serve(cfg, ecfg=None, n_instances=2, port=8080, device="cuda",
          params=None):
    """Build the service and its HTTP server on 127.0.0.1:``port`` (0 picks
    a free port: read it from ``httpd.server_address``). The caller runs
    ``httpd.serve_forever()`` and shuts both down."""
    svc = EngineService(cfg, ecfg or EngineConfig(), n_instances,
                        device=device, params=params)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(svc))
    return svc, httpd


def main():
    from repro_torch.configs import get_config
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model and KV pools live on")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the config's reduced variant (2 layers, "
                         "d_model 256) — the size the CPU can run")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV pool: quantized pages + scales, int8 "
                         "decode kernel, ~2x smaller replication messages")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: run prompts through the pool in "
                         "chunks of this many tokens, interleaved with "
                         "decode steps (0 = monolithic prefill)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="intern fully-covered prompt pages in a refcounted "
                         "prefix index; shared prefixes attach by reference "
                         "(copy-on-write) and skip prefill compute")
    ap.add_argument("--disaggregate", action="store_true",
                    help="prefill/decode disaggregation: the first half of "
                         "the instances run chunked prefill only and stream "
                         "finished KV pages to decode-role peers (implies "
                         "--prefill-chunk; defaults it to 8 if unset)")
    ap.add_argument("--recovery", default="kevlarflow",
                    choices=["kevlarflow", "standard"],
                    help="fail_instance policy: promote replicas + reroute "
                         "+ warm-spare rejoin, or restart + group-wide "
                         "weight-reload stall")
    ap.add_argument("--auto-rejoin", action="store_true",
                    help="bring a failed instance back automatically (warm "
                         "spare after --rejoin-delay s; standard mode after "
                         "--reload-penalty s)")
    ap.add_argument("--rejoin-delay", type=float, default=1.0)
    ap.add_argument("--reload-penalty", type=float, default=20.0)
    ap.add_argument("--placement", default="successor",
                    choices=["successor", "rendezvous"],
                    help="replication placement policy: next-alive ring "
                         "successor, or rendezvous hashing (fewer replicas "
                         "re-hosted on a membership change)")
    ap.add_argument("--n-shards", type=int, default=4,
                    help="tensor-parallel shards per instance — the unit "
                         "of shard-granularity faults (/v1/admin/fault "
                         "with granularity=shard degrades the instance to "
                         "its surviving slice instead of killing it)")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.disaggregate and args.prefill_chunk <= 0:
        args.prefill_chunk = 8      # streaming needs chunked prefill
    ecfg = EngineConfig(kv_quant=args.kv_quant,
                        prefill_chunk=args.prefill_chunk,
                        prefix_cache=args.prefix_cache,
                        disaggregate=args.disaggregate,
                        recovery=args.recovery,
                        auto_rejoin=args.auto_rejoin,
                        rejoin_delay=args.rejoin_delay,
                        reload_penalty=args.reload_penalty,
                        placement=args.placement,
                        n_shards=args.n_shards,
                        replicate=(args.recovery == "kevlarflow"))
    svc, httpd = serve(cfg, ecfg, n_instances=args.instances, port=args.port,
                       device=args.device)
    print(f"KevlarFlow serving {cfg.name} on :{httpd.server_address[1]} "
          f"({args.instances} instances of {args.n_shards} shards, "
          f"{args.recovery} recovery, {args.placement} placement, "
          f"{args.device}, {'int8' if args.kv_quant else 'bf16'} KV pool, "
          f"prefill chunk {args.prefill_chunk or 'off'}, prefix cache "
          f"{'on' if args.prefix_cache else 'off'}, "
          f"{'disaggregated' if args.disaggregate else 'colocated'}). "
          f"POST /v1/completions")
    try:
        httpd.serve_forever()
    finally:
        svc.shutdown(drain_timeout=30.0)


if __name__ == "__main__":
    main()
