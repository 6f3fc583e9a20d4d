"""The check that decides ``correct`` fails what it must: the harness is
driven on the CPU at a tiny size (its look for a card skipped) with the
timed path broken underneath, once for each fault a serving cell can have,
and ``correct`` comes out false; the sound run and the float8 control are
read beside them. A run on the card repeats the control at full size
(``-m gpu``)."""
import time

import pytest
import torch

from servebench import check as CHECK
from servebench import harness
from servebench.tiny import TINY_GAP_LIMIT, tiny_cell

SEED = 2**31 + 977


def run(cell_name, check_fn=CHECK.check):
    return harness.run_cell(tiny_cell(cell_name), SEED, 4.0, False,
                            t_start=time.time(), device="cpu",
                            check_fn=check_fn)


def _wrap_decode(monkeypatch, after):
    """Replace the paged decode step by one that post-processes its result:
    ``after(token_in, next_token, k_pages, v_pages, saved)``."""
    from repro_torch.models import paged_decode as PD
    real = PD.decode_step_paged

    def broken(cfg, params, token, k_pages, v_pages, *args, **kwargs):
        saved = (k_pages.clone(), v_pages.clone())
        nxt, logits = real(cfg, params, token, k_pages, v_pages, *args,
                           **kwargs)
        return after(token, nxt, k_pages, v_pages, saved), logits
    monkeypatch.setattr(PD, "decode_step_paged", broken)


def test_sound_run_is_correct():
    res = run("yi9b-rag-kill")
    assert res["correct"], res["checks"]
    assert res["checks"]["max_logit_gap"]["value"] < TINY_GAP_LIMIT / 3


def test_token_altered_where_produced(monkeypatch):
    _wrap_decode(monkeypatch, lambda tok, nxt, k, v, saved:
                 (nxt + 1) % 512)
    assert not run("yi9b-rag-kill")["correct"]


def test_step_that_leaves_its_state_unchanged(monkeypatch):
    def keep(tok, nxt, k, v, saved):
        k.copy_(saved[0])
        v.copy_(saved[1])
        return nxt
    _wrap_decode(monkeypatch, keep)
    assert not run("yi9b-rag-kill")["correct"]


def test_half_of_the_batch_left_out(monkeypatch):
    def half(tok, nxt, k, v, saved):
        out = nxt.clone()
        out[nxt.shape[0] // 2:] = tok[nxt.shape[0] // 2:]
        return out
    _wrap_decode(monkeypatch, half)
    assert not run("yi9b-rag-kill")["correct"]


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


def test_control_in_float8_fails_the_check():
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
    res = run("yi9b-rag-kill", control)
    assert all(c["ok"] for c in seen["program"].values()), seen["program"]
    assert res["checks"]["tokens_compared"]["value"] >= \
        res["checks"]["tokens_compared"]["min"]
    assert res["checks"]["max_logit_gap"]["value"] > \
        res["checks"]["max_logit_gap"]["limit"], res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", ["yi9b-rag-kill",
                                       "mixtral16-chat-batch"])
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
