"""The port's span recorder (``repro_torch.tracing``): off it hands back one
shared no-op object and records nothing; on it nests spans per thread with
their parents and attributes, on the benchmark tracer's host clock; and an
engine serves the same tokens with it on as off, with every work site
recorded and the benchmark's readers finding what they read."""
import dataclasses
import sys
import threading
import time
import tracemalloc
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import tracing as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving.engine import EngineConfig, RealEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def recorder():
    """A clean recorder, switched on; off and empty again afterwards."""
    T.disable()
    T.reset()
    T.enable()
    try:
        yield T
    finally:
        T.disable()
        T.reset()


def _off_sites():
    with T.span("fault.instance"):
        with T.span("decode.launch", tokens=32, device=True):
            T.token(3)


def test_off_returns_the_shared_noop_and_reads_no_clock(monkeypatch):
    T.disable()
    T.reset()
    assert T.span("x", tokens=7, device=True) is T.NOOP

    def clock():
        raise AssertionError("the clock was read while off")
    monkeypatch.setattr(T, "CLOCK", clock)
    _off_sites()
    tracemalloc.start()
    try:
        _off_sites()
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            _off_sites()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.size_diff > 0
             and d.traceback[0].filename == T.__file__]
    assert grown == []
    assert T.REC.spans == [] and T.REC.tokens == []


def test_spans_nest_with_parents_and_attributes(recorder):
    with T.span("fault.instance"):
        with T.span("prefill.chunk", tokens=512):
            with T.span("prefill.write_pages"):
                pass
        T.token(7)
        with T.span("decode.launch", tokens=4):
            pass
    data = T.export()
    names = [s["name"] for s in data["spans"]]
    assert names == ["fault.instance", "prefill.chunk",
                     "prefill.write_pages", "decode.launch"]
    step, chunk, pages, launch = data["spans"]
    assert [s["parent"] for s in data["spans"]] == [-1, 0, 1, 0]
    assert step["attrs"] == {} and pages["attrs"] == {}
    assert chunk["attrs"] == {"tokens": 512}
    assert launch["attrs"] == {"tokens": 4}
    assert step["start"] <= chunk["start"] <= pages["start"] \
        <= pages["end"] <= chunk["end"] <= launch["start"] \
        <= launch["end"] <= step["end"]
    assert all(s["end"] == s["host_end"] for s in data["spans"])
    (rid, t), = data["tokens"]
    assert rid == 7 and chunk["end"] <= t <= launch["start"]


def test_annotate_tags_the_innermost_open_span(recorder):
    """``annotate`` adds to the innermost span open in its thread; a tensor
    stays as it is until ``export`` gives it as a list; outside any span,
    or with the recorder off, it adds nothing."""
    T.annotate(pairs=1)
    rows = torch.tensor([3, 0, 5], dtype=torch.int32)
    with T.span("decode.launch", tokens=4):
        with T.span("moe.routed_mlp"):
            T.annotate(pairs=8, expert_rows=rows)
        T.annotate(pairs=2)
    assert T.REC.spans[1][T._ATTRS]["expert_rows"] is rows
    T.disable()
    with T.span("moe.routed_mlp"):
        T.annotate(pairs=99)
    launch, mlp = T.export()["spans"]
    assert launch["attrs"] == {"tokens": 4, "pairs": 2}
    assert mlp["attrs"] == {"pairs": 8, "expert_rows": [3, 0, 5]}


def test_two_threads_nest_their_own_spans(recorder):
    """An admin thread's spans never take the engine thread's open span as
    their parent, and no record is lost under contention."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n = 300

    def work(tag):
        for i in range(n):
            with T.span(f"{tag}.outer", tokens=i):
                with T.span(f"{tag}.inner", tokens=i):
                    T.token(i)
    try:
        threads = [threading.Thread(target=work, args=(tag,))
                   for tag in ("engine", "admin", "http")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    data = T.export()
    spans = data["spans"]
    assert len(spans) == 3 * 2 * n and len(data["tokens"]) == 3 * n
    for s in spans:
        tag, kind = s["name"].split(".")
        if kind == "outer":
            assert s["parent"] == -1
        else:
            parent = spans[s["parent"]]
            assert parent["name"] == f"{tag}.outer"
            assert parent["attrs"] == s["attrs"]


def test_clock_is_the_benchmark_tracers(recorder):
    """A span opened inside a method that the benchmark's tracer wraps
    falls inside the wrapper's own stamps: one host clock."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from servebench.trace import Tracer
    assert T.CLOCK is time.time_ns
    tracer = Tracer(profile_device=False)

    def method():
        with T.span("inner"):
            time.sleep(0.001)
    tracer._wrap("outer", method)()
    (name, t0, t1), = tracer.spans
    inner, = T.export()["spans"]
    assert t0 <= inner["start"] < inner["end"] <= t1


def _serve(trace: bool, chunk: int):
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              dtype="float32", kv_dtype="float32")
    eng = RealEngine(cfg, EngineConfig(max_slots=4, max_seq=64,
                                       prefill_chunk=chunk, auto_rejoin=True,
                                       rejoin_delay=2.0),
                     n_instances=2, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt_len=int(n), max_new_tokens=12,
                    arrival_time=0.0,
                    prompt_tokens=rng.integers(1, cfg.vocab_size, n).tolist())
            for i, n in enumerate((9, 20, 33, 12))]
    if trace:
        T.enable()
    try:
        for r in reqs:
            eng.submit(r)
        for _ in range(5):
            eng.step()
        eng.fail_instance(0)
        eng.run(400)
    finally:
        T.disable()
    return reqs, eng


@pytest.mark.parametrize("chunk", [0, 16])
def test_engine_serves_the_same_tokens_with_the_recorder_on(recorder, chunk):
    """Monolithic and chunked prefill, a kill mid-decode and the warm
    spare's rejoin: the same tokens and failure events either way, and
    with the recorder on every work site's span, one stamp per token, and
    the benchmark's host-read metrics read from the export."""
    T.disable()
    plain, plain_eng = _serve(trace=False, chunk=chunk)
    assert T.REC.spans == []
    traced, eng = _serve(trace=True, chunk=chunk)
    assert [r.output_tokens for r in traced] == \
        [r.output_tokens for r in plain]
    assert all(len(r.output_tokens) == 12 for r in traced)
    assert eng.failure_events == plain_eng.failure_events
    data = T.export()
    spans = data["spans"]
    names = {s["name"] for s in spans}
    prefill = {"prefill.chunk", "prefill.write_pages"} if chunk \
        else {"admit.prefill"}
    assert names == prefill | {
        "prefill.first_token", "decode.prepare", "decode.launch",
        "decode.sync", "decode.commit", "moe.routed_mlp", "fault.instance",
        "fault.recover_instance"}
    # one stamp per served token, each request's stamps under its own id
    # across the failover
    per_rid = {}
    for rid, _ in data["tokens"]:
        per_rid[rid] = per_rid.get(rid, 0) + 1
    assert per_rid == {r.rid: len(r.output_tokens) for r in traced}
    # prompts carry their real tokens; every routed MLP sits under the
    # decode launch or a prompt's span, whose tokens it is read by
    prompt = "prefill.chunk" if chunk else "admit.prefill"
    prompts = [s for s in spans if s["name"] == prompt]
    assert sum(s["attrs"]["tokens"] for s in prompts) == 9 + 20 + 33 + 12
    parents = {spans[s["parent"]]["name"] for s in spans
               if s["name"] == "moe.routed_mlp"}
    assert parents == {"decode.launch", prompt}
    assert all("tokens" in s["attrs"] for s in spans
               if s["name"] in ("decode.launch", prompt))
    assert [s["name"] for s in spans
            if s["name"].startswith("fault.")] == \
        ["fault.instance", "fault.recover_instance"]
    assert all(s["parent"] == -1 for s in spans
               if s["name"].startswith("fault."))
    # the benchmark's readers, on this export as a traced run keeps it
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from servebench import bench, program
    lo = min(s["start"] for s in spans) / 1e9 - 1.0
    hi = max(s["end"] for s in spans) / 1e9 + 1.0
    rec = types.SimpleNamespace(t_open=lo, t_close=hi, t_stop=hi,
                                device_name="cpu", model={})
    old, program.LAST = program.LAST, data
    try:
        read = {name: bench.load_metric_module(name).compute(rec)
                for name in ("decode_launch_ms", "prefill_us_per_token",
                             "itl_p90_s", "failover_ms", "rejoin_ms",
                             "moe_mlp_roofline")}
    finally:
        program.LAST = old
    assert all(read[name] > 0 for name in ("decode_launch_ms", "itl_p90_s",
                                           "failover_ms", "rejoin_ms"))
    assert (read["prefill_us_per_token"] > 0) if chunk else \
        read["prefill_us_per_token"] is None
    assert read["moe_mlp_roofline"] is None          # off the card
