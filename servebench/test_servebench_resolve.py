"""The harness finds every configuration, traffic mix and metric by name, a
dropped-in one included, and the measuring entry refuses to run off the
card and never writes a CPU number under a device metric's name."""
import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from servebench import bench, harness
from servebench.tiny import tiny_cell

BENCH = bench.load_json(bench.BENCHMARK)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = bench.resolve(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.config["name"] == entry["config"]
    assert c.traffic["loop"] in ("open", "closed")
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert {m.name for m in c.end_to_end} == want
    want = {m["name"] for m in BENCH["per_layer"]
            if cell in m.get("workloads", [cell])}
    assert {m.name for m in c.per_layer} == want
    assert "setup_s" in want or any(m.name == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_benchmark_file_keeps_the_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            e = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert cell in e.get("workloads", [cell])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        cfg = bench.load_json(bench.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["name"] == c["name"]


def test_dropped_in_files_are_found_by_name(tmp_path):
    shutil.copytree(bench.HERE, tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads(json.dumps(BENCH))
    sb = tmp_path / "servebench"
    cfg = bench.load_json(sb / "configs" / "yi-9b.json")
    cfg["name"] = "extra-model"
    (sb / "configs" / "extra-model.json").write_text(json.dumps(cfg))
    traffic = bench.load_json(sb / "traffic" / "rag-kill.json")
    traffic["kill"] = None
    (sb / "traffic" / "extra-mix.json").write_text(json.dumps(traffic))
    (sb / "metrics" / "extra_count.py").write_text(
        "def compute(record):\n    return float(len(record.requests))\n")
    b["configs"].append({"name": "extra-model", "source": "https://example.org",
                         "file": "servebench/configs/extra-model.json",
                         "reduced": [], "why": "drop-in"})
    b["workloads"].append({"name": "extra-cell", "config": "extra-model",
                           "traffic": "extra-mix", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "extra.count", "unit": "requests",
                           "better": "higher", "source": "program_counter",
                           "layer": "service loop and engine",
                           "moves": "output_tok_s.open", "workloads": ["extra-cell"]})
    # a metric split for the new cell is read by its base name's file
    b["per_layer"].append({"name": "engine_step_ms.extra", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "service loop and engine",
                           "moves": "output_tok_s.open", "workloads": ["extra-cell"]})
    e2e = next(m for m in b["end_to_end"] if m["name"] == "output_tok_s.open")
    e2e["workloads"].append("extra-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = bench.resolve("extra-cell", root=tmp_path)
    assert c.config["name"] == "extra-model" and c.traffic["kill"] is None
    extra = [m for m in c.per_layer if m.name == "extra.count"]
    assert extra and extra[0].compute(type("R", (), {"requests": [1, 2]})) == 2
    split = [m for m in c.per_layer if m.name == "engine_step_ms.extra"]
    assert split and split[0].compute(
        type("R", (), {"steps": [(1, 0.2, 1.0), (1, 0.4, 1.0)]})) == \
        pytest.approx(300.0)
    assert {m.name for m in c.end_to_end} == {"output_tok_s.open", "setup_s"}


def test_measuring_entry_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry would run")
    out = subprocess.run(
        [sys.executable, str(bench.HERE / "run.py"), "--workload",
         "yi9b-rag-kill", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=bench.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_cpu_run_writes_no_device_metric():
    cell = tiny_cell("yi9b-rag-kill")
    res = harness.run_cell(cell, 2**31 + 101, 4.0, True,
                           t_start=time.time(), device="cpu")
    device_metrics = {m["name"] for m in BENCH["per_layer"]
                      if m["source"] == "device_trace"}
    assert device_metrics
    assert not device_metrics & set(res["metrics"])
    assert not any(n.startswith("mfu") for n in res["metrics"])
    assert res["device"]["platform"] == "cpu"
    assert "busy_s" not in res["device"] and "breakdown" not in res
    assert res["correct"], res["checks"]
    assert {"engine_step_ms.open", "queue_wait_p50_s"} <= set(res["metrics"])


@pytest.mark.parametrize("starts_ms, window", [
    # only activity that started between the two stamps (0 and 50 ms) counts
    ([-2, 10, 20, 49, 51, 80], [10, 20, 49]),
    ([10, 30], [10, 30]),
    # none inside: no device number
    ([-5, 60], None),
])
def test_device_window_is_read_between_the_two_stamps(starts_ms, window):
    import torch
    from servebench.trace import Tracer

    class Ev:
        def __init__(self, start, dur):
            self.s, self.d = start, dur

        def device_type(self):
            return torch.autograd.DeviceType.CUDA

        def name(self):
            return f"k{self.s}"

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d

    t0, ms = 10**18, 1_000_000
    tr = Tracer(profile_device=False)
    tr.state = "done"
    tr.marks = {"start": t0, "end": t0 + 50 * ms}
    tr.edges = {"start": {"steps": 0}, "end": {"steps": 1}}
    events = [Ev(t0 + s * ms, ms // 2) for s in starts_ms]
    tr._results = type("R", (), {"events": lambda self: events})()
    if window is None:
        assert tr.device_events() == [] and tr.summary() is None
        return
    assert [r[1] for r in tr.device_events()] == [t0 + s * ms for s in window]
    s = tr.summary()
    assert s["busy_s"] == pytest.approx(len(window) * 5e-4)
    assert s["window_s"] == pytest.approx(0.05)
    assert s["launches"] == len(window)
