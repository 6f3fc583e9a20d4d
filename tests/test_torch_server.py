"""The port's HTTP server, started from its command line on the CPU
(``--device cpu --reduced``, ephemeral port): completion round-trip, the
typed /health schema, and an instance kill through /v1/admin/fault under
live traffic."""
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


def test_shard_fault_is_a_conflict_until_ported(base_url):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base_url + "/v1/admin/fault",
              {"granularity": "shard", "instance_id": 1, "shard_idx": 0})
    assert ei.value.code == 409
