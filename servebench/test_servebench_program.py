"""The readers of the port's own spans and token stamps, on hand-built
records with hand-counted values; the traced run's join to the port's
recorder; and, on the card, the shared clock that puts the recorder's spans
and the profiler's device events on one timeline (``-m gpu``)."""
import json
import time
import types

import pytest

from servebench import bench, program
from servebench.trace import Tracer

MS = 1_000_000
T0 = 1_700_000_000.0           # the window opens here (host seconds)
NS0 = int(T0 * 1e9)
MIXTRAL = {"d_model": 4096, "d_ff": 14336, "n_experts": 8, "top_k": 2,
           "dtype": "bfloat16"}
H100 = "NVIDIA H100 80GB HBM3"


def span(name, start_ms, end_ms, parent=-1, device=None, **attrs):
    """A span as the port exports it, times in ms from the window's open;
    ``device``: (start, end) of its work on the card, which then ends it."""
    s = {"name": name, "start": NS0 + int(start_ms * MS),
         "host_end": NS0 + int(end_ms * MS), "parent": parent,
         "attrs": attrs}
    s["end"] = s["host_end"]
    if device is not None:
        s["device_start"] = NS0 + int(device[0] * MS)
        s["device_end"] = NS0 + int(device[1] * MS)
        s["end"] = max(s["end"], s["device_end"])
    return s


@pytest.fixture(autouse=True)
def no_export_left():
    """Each test starts, and leaves, with no traced run's export kept."""
    program.LAST = None
    yield
    program.LAST = None


def record(spans=(), tokens=(), device_name=H100, model=MIXTRAL):
    """A run whose window is [0, 51 s) and whose service stopped at 60 s,
    with the port's export kept as a traced run keeps it."""
    program.LAST = {"spans": list(spans),
                    "tokens": [(rid, NS0 + int(s * 1e9))
                               for rid, s in tokens]}
    return types.SimpleNamespace(
        t_open=T0, t_close=T0 + 51.0, t_stop=T0 + 60.0, model=model,
        device_name=device_name)


def reader(name):
    return bench.load_metric_module(name).compute


NEW = ["decode_launch_ms", "prefill_us_per_token", "itl_p90_s",
       "failover_ms", "rejoin_ms", "moe_mlp_roofline"]


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_without_the_ports_spans(name):
    """A port without the recorder (or a run with no such span): None."""
    empty = types.SimpleNamespace(t_open=T0, t_close=T0 + 51.0,
                                  t_stop=T0 + 60.0, model=MIXTRAL,
                                  device_name=H100)
    assert reader(name)(empty) is None
    assert reader(name)(record()) is None


def test_decode_launch_is_the_mean_host_time_in_the_window():
    rec = record([span("decode.launch", 100, 110, tokens=4),
                  span("decode.launch", 200, 220, tokens=4),
                  span("decode.launch", -50, -20, tokens=4),   # before
                  span("decode.launch", 52_000, 52_090, tokens=4),  # after
                  span("decode.sync", 110, 190)])
    assert reader("decode_launch_ms")(rec) == pytest.approx(15.0)


def test_prefill_per_token_runs_to_each_chunks_device_completion():
    rec = record([
        # host returns at 20 ms, the card finishes at 60 ms
        span("prefill.chunk", 0, 20, device=(1, 60), tokens=512),
        span("prefill.chunk", 100, 112, tokens=100),
        span("prefill.chunk", -100, -40, tokens=512)])   # before
    # (60 + 12) ms over 612 tokens
    assert reader("prefill_us_per_token")(rec) == \
        pytest.approx(72e3 / 612)


def test_itl_p90_over_consecutive_stamps_of_one_request():
    # request 1: gaps 0.01 .. 0.09 s; request 2: one gap of 0.5 s; stamps
    # before the open or after the close pair with nothing
    t, stamps = 1.0, [(1, 1.0)]
    for g in range(1, 10):
        t += g / 100
        stamps.append((1, t))
    stamps += [(2, -0.2), (2, 3.0), (2, 3.5), (2, 51.3)]
    gaps = sorted([g / 100 for g in range(1, 10)] + [0.5])
    assert reader("itl_p90_s")(record(tokens=stamps)) == \
        pytest.approx(gaps[8])          # nearest rank: the 9th of 10


def test_failover_and_rejoin_run_to_device_completion_until_the_stop():
    rec = record([
        span("fault.instance", 11_300, 11_310, device=(11_301, 11_340)),
        # the rejoin fell after the close, before the service stopped
        span("fault.recover_instance", 52_000, 52_100,
             device=(52_001, 52_250)),
        span("fault.recover_instance", -900, -800)])     # before the open
    assert reader("failover_ms")(rec) == pytest.approx(40.0)
    assert reader("rejoin_ms")(rec) == pytest.approx(250.0)


def test_moe_roofline_counts_each_calls_real_tokens_hand_count():
    d, f = 4096, 14336
    weights_s = 8 * 3 * d * f * 2 / 3.35e12      # every expert, bf16, once
    rec = record([
        span("decode.launch", 0, 30, tokens=32),
        span("moe.routed_mlp", 1, 2, parent=0, device=(5, 13.1)),
        span("admit.prefill", 100, 200, tokens=2048),
        span("moe.routed_mlp", 101, 102, parent=2, device=(110, 130))])
    decode_bound = max(weights_s, 6 * d * f * 2 * 32 / 989e12)
    prefill_bound = max(weights_s, 6 * d * f * 2 * 2048 / 989e12)
    assert decode_bound == weights_s and prefill_bound > weights_s
    want = 100 * (decode_bound + prefill_bound) / (8.1e-3 + 20e-3)
    assert reader("moe_mlp_roofline")(rec) == pytest.approx(want)
    assert 8.0 < want < 8.3
    cpu = record(program.LAST["spans"], device_name="cpu")
    assert reader("moe_mlp_roofline")(cpu) is None


def _empty_spans_file(tmp_path):
    path = tmp_path / "spans.json"
    path.write_text(json.dumps({"spans": []}))
    return path


def test_traced_run_records_the_port_and_labels_idle_by_its_spans(tmp_path):
    """From the tracer's install to its uninstall the port's recorder is
    on; its spans join the tracer's, so a gap on the card inside one is
    put down to it rather than to the wrapped method around it."""
    import torch
    from repro_torch import tracing
    tr = Tracer(spans_file=_empty_spans_file(tmp_path), profile_device=False)
    tr.install()
    try:
        assert tracing.enabled()
        with tracing.span("decode.launch", tokens=3):
            time.sleep(0.002)
    finally:
        tr.uninstall()
    assert not tracing.enabled()
    (name, s0, s1), = tr.spans
    assert name == "decode.launch" and program.LAST["spans"][0]["start"] == s0
    tracing.reset()

    # the wrapped method around it, and the card busy at both ends only
    tr.spans.append(("instance.decode_step", s0 - MS, s1 + MS))
    events = [(s0 - MS, MS // 2), (s1, MS // 2)]

    class Ev:
        def __init__(self, start, dur):
            self.s, self.d = start, dur

        def device_type(self):
            return torch.autograd.DeviceType.CUDA

        def name(self):
            return "k"

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d
    tr.state = "done"
    tr.marks = {"start": s0 - MS, "end": s1 + MS}
    tr.edges = {"start": {"steps": 0}, "end": {"steps": 1}}
    tr._results = type("R", (), {"events": lambda self: [
        Ev(s, dur) for s, dur in events]})()
    idle = dict(tr.summary()["idle_gaps"])
    assert idle["decode.launch"] == pytest.approx((s1 - s0 + MS // 2) / 1e9)
    assert idle.get("instance.decode_step", 0) == pytest.approx(
        (MS // 2) / 1e9)


@pytest.mark.gpu
def test_kernel_in_a_span_starts_after_it_on_the_profilers_timeline(
        tmp_path):
    """The premise the traced run reads the card by: the recorder's host
    stamps and the profiler's device events share one clock. A kernel
    launched inside a span starts after the span's start and within 1 ms
    of it, and the span's own device start (its CUDA events, placed on the
    host clock) agrees to 1 ms."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import tracing
    x = torch.randn(2048, 2048, device="cuda")
    x @ x
    torch.cuda.synchronize()
    tr = Tracer(spans_file=_empty_spans_file(tmp_path), profile_device=True)
    tr.warm_up()
    tracing.reset()
    tracing.enable()
    try:
        tr.start({})
        for _ in range(5):
            with tracing.span("probe", device=True):
                x @ x
            torch.cuda.synchronize()
            time.sleep(0.01)
        tr.stop({})
    finally:
        tracing.disable()
        tr.finish()
    spans = tracing.export()["spans"]
    tracing.reset()
    kernels = [e for e in tr.device_events() if e[3]]
    assert len(spans) == 5 and kernels
    for s in spans:
        near = [k[1] for k in kernels
                if s["start"] - MS <= k[1] <= s["host_end"] + MS]
        assert near, s
        first = min(near)
        assert s["start"] <= first <= s["start"] + MS
        assert abs(s["device_start"] - first) <= MS
        assert s["device_end"] >= first
