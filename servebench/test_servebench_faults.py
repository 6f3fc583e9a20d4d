"""The check that decides ``correct`` fails what it must: the harness is
driven on the CPU at a tiny size (its look for a card skipped) with the
timed path broken underneath, once for each fault a serving cell can have,
and ``correct`` comes out false; the sound run and the float8 control are
read beside them. A run on the card repeats the control at full size
(``-m gpu``)."""
import time

import pytest
import torch

from servebench import bench, harness
from servebench import check as CHECK
from servebench.tiny import TINY_GAP_LIMIT, tiny_cell

SEED = 2**31 + 977
CELLS = [w["name"] for w in bench.load_json(bench.BENCHMARK)["workloads"]]
# the dense cells other than yi9b-rag-kill, which the named tests below
# drive: the tiny cut of a dense cell is held to the tiny limit (the tiny
# MoE model's routing sits near ties, see tiny.py)
OTHER_DENSE = [c for c in CELLS if c != "yi9b-rag-kill" and
               bench.resolve(c).config["model"]["arch_type"] == "dense"]
# the cells whose engine replicates KV to its ring peer (the port's default)
REPLICATING = [c for c in CELLS
               if bench.resolve(c).config["engine"].get("replicate", True)]


def run(cell_name, check_fn=CHECK.check):
    return harness.run_cell(tiny_cell(cell_name), SEED, 4.0, False,
                            t_start=time.time(), device="cpu",
                            check_fn=check_fn)


def _wrap_decode(monkeypatch, after):
    """Replace the paged decode step by one that post-processes its result:
    ``after(token_in, next_token, k_pages, v_pages, saved, block_tables)``."""
    from repro_torch.models import paged_decode as PD
    real = PD.decode_step_paged

    def broken(cfg, params, token, k_pages, v_pages, *args, **kwargs):
        saved = (k_pages.clone(), v_pages.clone())
        nxt, logits = real(cfg, params, token, k_pages, v_pages, *args,
                           **kwargs)
        return after(token, nxt, k_pages, v_pages, saved, args[0]), logits
    monkeypatch.setattr(PD, "decode_step_paged", broken)


def replicas_read_back_equal(checks):
    assert checks["replica_blocks_compared"]["value"] >= 8, checks
    assert checks["replica_blocks_differing"]["value"] == 0, checks
    assert checks["replica_blocks_missing"]["value"] == 0, checks


def test_sound_run_is_correct():
    res = run("yi9b-rag-kill")
    assert res["correct"], res["checks"]
    assert res["checks"]["max_logit_gap"]["value"] < TINY_GAP_LIMIT / 3
    replicas_read_back_equal(res["checks"])


@pytest.mark.parametrize(
    "cell_name", [c for c in REPLICATING
                  if c != "yi9b-rag-kill" and c not in OTHER_DENSE])
def test_sound_run_reads_its_replicas_back_equal(cell_name):
    """The cells whose sound tiny run is not held to the gap limit (the
    tiny MoE model, see tiny.py): their replicas are read back all the
    same."""
    replicas_read_back_equal(run(cell_name)["checks"])


def altered(tok, nxt, k, v, saved, tables):
    return (nxt + 1) % 512


def unchanged(tok, nxt, k, v, saved, tables):
    k.copy_(saved[0])
    v.copy_(saved[1])
    return nxt


def half(tok, nxt, k, v, saved, tables):
    out = nxt.clone()
    out[nxt.shape[0] // 2:] = tok[nxt.shape[0] // 2:]
    return out


def half_of_busy(tok, nxt, k, v, saved, tables):
    """The upper half of the busy slots (a lone one included) left out. An
    idle slot points every page at the scratch block; without a kill piling
    victims onto one instance, the upper half of all slots may stay idle."""
    busy = (~(tables == tables[:, :1]).all(1)).nonzero()[:, 0]
    left = busy[len(busy) // 2:]
    out = nxt.clone()
    out[left] = tok[left]
    return out


def test_token_altered_where_produced(monkeypatch):
    _wrap_decode(monkeypatch, altered)
    assert not run("yi9b-rag-kill")["correct"]


def test_step_that_leaves_its_state_unchanged(monkeypatch):
    _wrap_decode(monkeypatch, unchanged)
    assert not run("yi9b-rag-kill")["correct"]


def test_half_of_the_batch_left_out(monkeypatch):
    _wrap_decode(monkeypatch, half)
    assert not run("yi9b-rag-kill")["correct"]


@pytest.mark.parametrize("cell_name", OTHER_DENSE)
def test_other_dense_cell_sound_run_is_correct(cell_name):
    res = run(cell_name)
    assert res["correct"], res["checks"]
    assert res["checks"]["max_logit_gap"]["value"] < TINY_GAP_LIMIT / 3
    replicas_read_back_equal(res["checks"])


@pytest.mark.parametrize("fault", [altered, unchanged, half_of_busy],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell_name", OTHER_DENSE)
def test_other_dense_cell_fails_each_decode_fault(cell_name, fault,
                                                  monkeypatch):
    _wrap_decode(monkeypatch, fault)
    assert not run(cell_name)["correct"]


def test_exchange_between_instances_left_out(monkeypatch):
    from repro_torch.serving.kvcache import PagedKVPool
    monkeypatch.setattr(PagedKVPool, "copy_blocks_to",
                        lambda self, other, src, dst: None)
    seen = {}

    def check(config, model, params, record, seed):
        reqs = CHECK.sample(record, seed,
                            int(config["check"]["sample_requests"]))
        seen["resumed"] = sum(1 for r in reqs if r["migrations"])
        return CHECK.verdict(config, record, reqs,
                             CHECK.served_gaps(model, params, reqs))
    res = run("yi9b-rag-kill", check)
    assert seen["resumed"] >= 1
    assert not res["correct"]


def copy_left_out(monkeypatch):
    """The copy between the pools never made: the replicas keep whatever
    their blocks held."""
    from repro_torch.serving.kvcache import PagedKVPool
    monkeypatch.setattr(PagedKVPool, "copy_blocks_to",
                        lambda self, other, src, dst: None)


def flush_deferred(monkeypatch):
    """Replication staged and never shipped: every flush, the close's
    barrier included, defers it again."""
    from repro_torch.serving.transport import TransportChannel
    monkeypatch.setattr(TransportChannel, "flush",
                        lambda self, block=False, exclude=None: None)


@pytest.mark.parametrize("fault", [copy_left_out, flush_deferred],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell_name", REPLICATING)
def test_replicating_cell_fails_when_the_exchange_is_left_out(
        cell_name, fault, monkeypatch):
    fault(monkeypatch)
    res = run(cell_name)
    assert not res["correct"]
    assert res["checks"]["replica_blocks_differing"]["value"] > 0, \
        res["checks"]


def control_fails_the_check(cell_name):
    """The control: the reference in float8 in the program's place, read at
    the sound run's prompts and tokens (the dense cell; the MoE cell's
    control runs on the card, below)."""
    seen = {}

    def control(config, model, params, record, seed):
        reqs = CHECK.sample(record, seed, int(config["check"]["sample_requests"]))
        seen["program"] = CHECK.verdict(
            config, record, reqs, CHECK.served_gaps(model, params, reqs))
        return CHECK.verdict(config, record, reqs, CHECK.served_gaps(
            model, params, reqs, precision="fp8"))
    res = run(cell_name, control)
    assert all(c["ok"] for c in seen["program"].values()), seen["program"]
    assert res["checks"]["tokens_compared"]["value"] >= \
        res["checks"]["tokens_compared"]["min"]
    assert res["checks"]["max_logit_gap"]["value"] > \
        res["checks"]["max_logit_gap"]["limit"], res["checks"]


def test_control_in_float8_fails_the_check():
    control_fails_the_check("yi9b-rag-kill")


@pytest.mark.parametrize("cell_name", OTHER_DENSE)
def test_other_dense_cell_control_in_float8_fails_the_check(cell_name):
    control_fails_the_check(cell_name)


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", REPLICATING)
def test_exchange_left_out_fails_at_full_size_on_the_card(cell_name,
                                                          monkeypatch):
    """The copy between the pools left out, at the cell's own size, load
    and window, on three seeds: every run reads replica blocks that
    differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = bench.resolve(cell_name)
    seconds = float(bench.load_json(bench.BENCHMARK)["run_seconds"])
    copy_left_out(monkeypatch)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        res = harness.run_cell(cell, seed, seconds, False,
                               t_start=time.time())
        checks = res["checks"]
        print(cell_name, seed, {k: c["value"] for k, c in checks.items()})
        assert not res["correct"]
        assert checks["replica_blocks_differing"]["value"] > 0, checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_at_full_size_on_the_card(cell_name):
    """The control at the cell's own size and load, on three seeds: every
    run compares enough tokens, and a gap number the configuration holds
    fails its limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from servebench import bench
    cell = bench.resolve(cell_name)
    seconds = float(bench.load_json(bench.BENCHMARK)["run_seconds"])

    def control(config, model, params, record, seed):
        reqs = CHECK.sample(record, seed, int(config["check"]["sample_requests"]))
        return CHECK.verdict(config, record, reqs, CHECK.served_gaps(
            model, params, reqs, precision="fp8"))
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        res = harness.run_cell(cell, seed, seconds, False,
                               t_start=time.time(), check_fn=control)
        checks = res["checks"]
        assert checks["tokens_compared"]["value"] >= \
            checks["tokens_compared"]["min"]
        gaps = [c for name, c in checks.items() if name.endswith("_gap")]
        assert any(c["value"] > c["limit"] for c in gaps), checks
