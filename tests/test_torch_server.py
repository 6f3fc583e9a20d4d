"""The port's HTTP server, started from its command line on the CPU
(``--device cpu --reduced``, ephemeral port): completion round-trip, the
typed /health schema, an instance kill through /v1/admin/fault under live
traffic, shard faults and their recovery, and the prefix-cache and
disaggregated services."""
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.serving.api_types import HealthResponse  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
VOCAB = 1024            # reduced llama3-8b


def _server(*flags):
    """Start the server's command line on an ephemeral port; yield its
    base URL and stop it afterwards."""
    # one intra-op thread: the suite runs in parallel workers on few cores
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.serving.server",
         "--device", "cpu", "--reduced", "--port", "0", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT)
    try:
        line = proc.stdout.readline()
        m = re.search(r"on :(\d+) ", line)
        assert m, f"server did not start: {line!r}"
        yield f"http://127.0.0.1:{m.group(1)}"
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


@pytest.fixture(scope="module")
def base_url():
    yield from _server()


@pytest.fixture(scope="module")
def int8_url():
    """The int8 pool with chunked prefill (chunks of 8 tokens)."""
    yield from _server("--kv-quant", "--prefill-chunk", "8")


@pytest.fixture(scope="module")
def prefix_url():
    """The bf16 pool with the prefix cache (monolithic prefill)."""
    yield from _server("--prefix-cache")


@pytest.fixture(scope="module")
def shard_url():
    """Four instances of 4 shards each under rendezvous placement."""
    yield from _server("--instances", "4", "--n-shards", "4",
                       "--placement", "rendezvous")


@pytest.fixture(scope="module")
def disagg_url():
    """Prefill/decode roles; the chunk size defaults to 8."""
    yield from _server("--disaggregate")


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _health(base_url):
    with urllib.request.urlopen(base_url + "/health", timeout=10) as r:
        return json.loads(r.read())


def test_completion_roundtrip(base_url):
    toks = np.random.default_rng(0).integers(1, VOCAB, 8).tolist()
    out = _post(base_url + "/v1/completions",
                {"prompt_tokens": toks, "max_tokens": 6})
    assert out["object"] == "text_completion"
    assert out["model"] == "llama3-8b-reduced"
    assert len(out["choices"][0]["token_ids"]) == 6
    assert out["usage"]["prompt_tokens"] == 8
    assert 0 < out["timing"]["ttft"] <= out["timing"]["latency"]
    again = _post(base_url + "/v1/completions",
                  {"prompt_tokens": toks, "max_tokens": 6})
    assert again["choices"][0]["token_ids"] == out["choices"][0]["token_ids"]


def test_health_roundtrips_typed_schema(base_url):
    h = _health(base_url)
    assert HealthResponse.from_json(h).to_json() == h
    assert h["status"] == "ok" and len(h["instances"]) == 2
    assert h["recovery_mode"] == "kevlarflow"
    assert set(h["topology"]["states"]) == {"0", "1"}


def _kill_under_live_traffic(base_url, prompt_len, max_tokens):
    """Concurrent requests; once all of them hold slots and instance 0 is
    decoding, kill it through /v1/admin/fault. Returns (responses, fault
    reply, instance 0's ``prefilling`` read just before the fault)."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, VOCAB, prompt_len).tolist() for _ in range(6)]
    results, errs = [], []

    def one(p):
        try:
            results.append(_post(base_url + "/v1/completions",
                                 {"prompt_tokens": p,
                                  "max_tokens": max_tokens}))
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    threads = [threading.Thread(target=one, args=(p,)) for p in prompts]
    for t in threads:
        t.start()
    deadline = time.time() + 60
    while True:
        # every request holds a slot (none can be admitted onto instance 0
        # after this read) and instance 0 is decoding
        inst = _health(base_url)["instances"]
        inst0 = inst[0]
        if sum(i["active"] for i in inst) == len(prompts) and \
                inst0["active"] > inst0["prefilling"]:
            break
        assert time.time() < deadline, "instance 0 never started decoding"
        time.sleep(0.005)
    out = _post(base_url + "/v1/admin/fault",
                {"granularity": "instance", "instance_id": 0,
                 "if_busy": True})
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert len(results) == 6
    return results, out, inst0["prefilling"]


def test_instance_kill_under_live_traffic(base_url):
    """Concurrent requests; once instance 0 is decoding, kill it through
    /v1/admin/fault. Every request completes, the victims migrate (no
    retries), and /health shows the survivor serving."""
    results, out, _ = _kill_under_live_traffic(base_url, 12, 200)
    assert out["applied"] and out["seamlessly_resumed"]
    assert all(len(r["choices"][0]["token_ids"]) == 200 for r in results)
    assert any(r["kevlarflow"]["migrations"] == 1 for r in results)
    assert all(r["kevlarflow"]["retries"] == 0 for r in results)
    h = _health(base_url)
    assert [i["alive"] for i in h["instances"]] == [False, True]
    assert h["topology"]["states"] == {"0": "DEAD", "1": "HEALTHY"}
    assert h["failure_events"][0]["resumed"] >= 1
    # the survivor keeps serving
    toks = np.random.default_rng(3).integers(1, VOCAB, 5).tolist()
    out = _post(base_url + "/v1/completions",
                {"prompt_tokens": toks, "max_tokens": 3})
    assert len(out["choices"][0]["token_ids"]) == 3


def test_int8_chunked_completion_roundtrip(int8_url):
    """--kv-quant --prefill-chunk 8: a 20-token prompt (three chunks)
    completes, greedy decoding is deterministic, /health reports the
    per-instance prefill depth, and each replicated block carries the
    int8 payload plus its bf16 scales."""
    toks = np.random.default_rng(2).integers(1, VOCAB, 20).tolist()
    out = _post(int8_url + "/v1/completions",
                {"prompt_tokens": toks, "max_tokens": 6})
    assert len(out["choices"][0]["token_ids"]) == 6
    assert out["usage"]["prompt_tokens"] == 20
    again = _post(int8_url + "/v1/completions",
                  {"prompt_tokens": toks, "max_tokens": 6})
    assert again["choices"][0]["token_ids"] == out["choices"][0]["token_ids"]
    h = _health(int8_url)
    assert HealthResponse.from_json(h).to_json() == h
    assert all(i["prefilling"] == 0 for i in h["instances"])
    repl = h["replication"]
    assert repl["blocks_total"] > 0
    # reduced llama3-8b: 2 layers x 2 KV heads x page 8 rows of D 64
    rows = 2 * 2 * 8
    assert repl["bytes_total"] == repl["blocks_total"] * (
        2 * rows * 64 + 2 * rows * 2)


def test_int8_chunked_instance_kill_under_live_traffic(int8_url):
    """The kill drill on the int8 pool with chunked prefill: every request
    completes; requests that were decoding on the victim migrate, and only
    requests caught mid-prefill on it may restart."""
    results, out, prefilling = _kill_under_live_traffic(int8_url, 20, 40)
    assert out["applied"] and out["seamlessly_resumed"]
    assert all(len(r["choices"][0]["token_ids"]) == 40 for r in results)
    assert any(r["kevlarflow"]["migrations"] == 1 for r in results)
    retries = sum(r["kevlarflow"]["retries"] for r in results)
    assert retries <= prefilling
    h = _health(int8_url)
    assert [i["alive"] for i in h["instances"]] == [False, True]
    event = h["failure_events"][0]
    assert event["resumed"] == len(out["seamlessly_resumed"])
    assert event["restarted"] == retries


def _status(url, payload):
    """POST and return the HTTP status code (2xx or the error's)."""
    try:
        _post(url, payload)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def test_shard_fault_degrades_and_recovers_over_http(shard_url):
    """A shard fault degrades instance 1 (3 of 4 shards survive): /health
    shows it DEGRADED with lost_shards [0], 6 of 8 slots, capacity 0.75 and
    the layout of the surviving slice; it keeps serving; a shard recover
    restores it and closes the event."""
    out = _post(shard_url + "/v1/admin/fault",
                {"granularity": "shard", "instance_id": 1, "shard_idx": 0})
    assert out["applied"] and out["fault"]["shard_idx"] == 0
    h = _health(shard_url)
    assert HealthResponse.from_json(h).to_json() == h
    deg = h["instances"][1]["degradation"]
    assert deg["state"] == "DEGRADED" and deg["lost_shards"] == [0]
    assert deg["n_shards"] == 4 and deg["slot_cap"] == 6
    assert deg["capacity_frac"] == 0.75
    layout = deg["layout"]
    assert layout["n_shards"] == 4 and layout["surviving"] == 3
    assert layout["lost_shards"] == [0] and layout["capacity_frac"] == 0.75
    # d_model 256 is not divisible by 3: every model-sharded weight falls
    # back to replication, so each shard holds more bytes
    assert layout["param_bytes_per_shard_degraded"] > \
        layout["param_bytes_per_shard_full"]
    assert h["topology"]["states"]["1"] == "DEGRADED"
    assert h["topology"]["degraded"] == {"1": [0]}
    assert h["instances"][0]["degradation"]["layout"] is None
    toks = np.random.default_rng(5).integers(1, VOCAB, 9).tolist()
    done = _post(shard_url + "/v1/completions",
                 {"prompt_tokens": toks, "max_tokens": 4})
    assert len(done["choices"][0]["token_ids"]) == 4
    out = _post(shard_url + "/v1/admin/recover",
                {"granularity": "shard", "instance_id": 1})
    assert out["recovered"]["granularity"] == "shard"
    h = _health(shard_url)
    deg = h["instances"][1]["degradation"]
    assert deg["state"] == "HEALTHY" and deg["lost_shards"] == []
    assert deg["slot_cap"] == 8 and deg["capacity_frac"] == 1.0
    assert deg["layout"] is None
    event = h["failure_events"][-1]
    assert event["granularity"] == "shard" and event["shard_idx"] == 0
    assert event["instance"] == 1 and event["mttr"] >= 0


def test_shard_fault_on_dead_instance_is_a_conflict(shard_url):
    """State conflicts answer 409: a shard fault on a dead instance, and a
    shard recover of an instance that lost no shard."""
    out = _post(shard_url + "/v1/admin/fault",
                {"granularity": "instance", "instance_id": 3})
    assert out["applied"]
    assert _status(shard_url + "/v1/admin/fault",
                   {"granularity": "shard", "instance_id": 3,
                    "shard_idx": 1}) == 409
    assert _status(shard_url + "/v1/admin/recover",
                   {"granularity": "shard", "instance_id": 2}) == 409
    _post(shard_url + "/v1/admin/recover",
          {"granularity": "instance", "instance_id": 3})
    assert _health(shard_url)["instances"][3]["alive"]


def test_malformed_shard_spec_is_a_bad_request(shard_url):
    """Shape errors answer 400 before any state changes: shard_idx at or
    past --n-shards, or a shard fault without one."""
    for spec in ({"granularity": "shard", "instance_id": 0, "shard_idx": 4},
                 {"granularity": "shard", "instance_id": 0}):
        assert _status(shard_url + "/v1/admin/fault", spec) == 400
    h = _health(shard_url)
    assert all(i["degradation"]["state"] == "HEALTHY"
               for i in h["instances"])


def _shared_prefix_prompts():
    rng = np.random.default_rng(4)
    shared = rng.integers(1, VOCAB, 24).tolist()       # three full pages
    return [shared + [7, 8, 9], shared + [10, 11], shared[:20] + [12, 13]]


def test_prefix_cache_server_equals_cold_serving(prefix_url, base_url):
    """--prefix-cache: requests sharing a 24-token prefix hit the cache
    (one diverges inside page 2: a copy-on-write), /health's prefix section
    shows it, and every stream equals the server without the cache."""
    prompts = _shared_prefix_prompts()
    cold = [_post(base_url + "/v1/completions",
                  {"prompt_tokens": p, "max_tokens": 6})
            for p in prompts]
    warm = [_post(prefix_url + "/v1/completions",
                  {"prompt_tokens": p, "max_tokens": 6})
            for p in prompts]
    assert [r["choices"][0]["token_ids"] for r in warm] == \
        [r["choices"][0]["token_ids"] for r in cold]
    h = _health(prefix_url)
    assert HealthResponse.from_json(h).to_json() == h
    prefix = h["prefix"]
    assert prefix["enabled"] and not h["disagg"]["enabled"]
    assert prefix["prefix_cached_tokens"] >= 24 + 16
    assert prefix["cow_copies"] >= 1
    # monolithic prefill computes every prompt token
    assert prefix["prefill_compute_tokens"] == prefix["prefill_total_tokens"]
    assert prefix["shared_page_ship_ratio"] <= 1.0
    assert not _health(base_url)["prefix"]["enabled"]


def test_disaggregated_server_roles_and_handoffs(disagg_url, base_url):
    """--disaggregate: instance 0 prefills, instance 1 decodes; every
    request is handed off (one bf16 block per handoff message page), the
    per-instance handoffs_ready field is there, and the streams equal the
    colocated server's."""
    prompts = _shared_prefix_prompts()
    colo = [_post(base_url + "/v1/completions",
                  {"prompt_tokens": p, "max_tokens": 6})
            for p in prompts]
    dis = [_post(disagg_url + "/v1/completions",
                 {"prompt_tokens": p, "max_tokens": 6})
           for p in prompts]
    assert [r["choices"][0]["token_ids"] for r in dis] == \
        [r["choices"][0]["token_ids"] for r in colo]
    h = _health(disagg_url)
    assert HealthResponse.from_json(h).to_json() == h
    assert [i["role"] for i in h["instances"]] == ["prefill", "decode"]
    assert all(i["handoffs_ready"] == 0 for i in h["instances"])
    d = h["disagg"]
    assert d["enabled"] and d["roles"] == {"0": "prefill", "1": "decode"}
    assert d["handoffs_seated"] == len(prompts)
    assert d["handoffs_in_flight"] == 0
    # reduced llama3-8b bf16 block: 2 layers x 2 KV heads x page 8 x D 64
    assert d["handoff_blocks_total"] >= 3 * len(prompts)
    assert d["handoff_bytes_total"] == d["handoff_blocks_total"] * (
        2 * 2 * 2 * 8 * 64 * 2)
    assert h["topology"]["roles"] == {"0": "prefill", "1": "decode"}


def test_fail_instance_if_busy_kills_only_a_busy_instance():
    """EngineService.fail_instance_if_busy: a no-op (None) on an idle
    instance, a kill that resumes its requests on a busy one. The service
    loop is stopped so the engine is stepped by hand, in a known state."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.server import EngineService

    svc = EngineService(get_config("llama3-8b").reduced(),
                        EngineConfig(max_slots=4, max_seq=64), n_instances=2,
                        device="cpu")
    svc.shutdown()
    eng = svc.engine
    assert svc.fail_instance_if_busy(0) is None
    assert svc.fail_instance_if_busy(1) is None
    assert all(i.alive for i in eng.instances)
    rng = np.random.default_rng(0)
    reqs = [svc.submit(rng.integers(1, VOCAB, 6).tolist(), 8)
            for _ in range(4)]
    while not all(r.output_tokens for r in reqs):
        eng.step()
    busy = next(i for i in eng.instances if i.requests)
    held = sorted(busy.requests)
    resumed = svc.fail_instance_if_busy(busy.instance_id)
    assert sorted(resumed) == held
    assert not busy.alive
    eng.run(max_iters=500)
    assert sorted(r.rid for r in eng.done) == [r.rid for r in reqs]
