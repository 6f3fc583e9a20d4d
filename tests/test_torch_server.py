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


@pytest.fixture(scope="module")
def base_url():
    # one intra-op thread: the suite runs in parallel workers on few cores
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.serving.server",
         "--device", "cpu", "--reduced", "--port", "0"],
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


def test_instance_kill_under_live_traffic(base_url):
    """Concurrent requests; once instance 0 is decoding, kill it through
    /v1/admin/fault. Every request completes, the victims migrate (no
    retries), and /health shows the survivor serving."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, VOCAB, 12).tolist() for _ in range(6)]
    results, errs = [], []

    def one(p):
        try:
            results.append(_post(base_url + "/v1/completions",
                                 {"prompt_tokens": p, "max_tokens": 200}))
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    threads = [threading.Thread(target=one, args=(p,)) for p in prompts]
    for t in threads:
        t.start()
    deadline = time.time() + 60
    while _health(base_url)["instances"][0]["active"] == 0:
        assert time.time() < deadline, "instance 0 never started decoding"
        time.sleep(0.005)
    out = _post(base_url + "/v1/admin/fault",
                {"granularity": "instance", "instance_id": 0,
                 "if_busy": True})
    assert out["applied"] and out["seamlessly_resumed"]
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert len(results) == 6
    assert all(len(r["choices"][0]["token_ids"]) == 200 for r in results)
    assert any(r["kevlarflow"]["migrations"] == 1 for r in results)
    assert all(r["kevlarflow"]["retries"] == 0 for r in results)
    h = _health(base_url)
    assert [i["alive"] for i in h["instances"]] == [False, True]
    assert h["topology"]["states"] == {"0": "DEAD", "1": "HEALTHY"}
    assert h["failure_events"][0]["resumed"] >= 1
    # the survivor keeps serving
    toks = rng.integers(1, VOCAB, 5).tolist()
    out = _post(base_url + "/v1/completions",
                {"prompt_tokens": toks, "max_tokens": 3})
    assert len(out["choices"][0]["token_ids"]) == 3


def test_shard_fault_is_a_conflict_until_ported(base_url):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base_url + "/v1/admin/fault",
              {"granularity": "shard", "instance_id": 1, "shard_idx": 0})
    assert ei.value.code == 409
