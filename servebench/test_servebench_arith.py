"""The benchmark's arithmetic against hand counts: percentiles over every
request sent (a failure counts as infinitely late), timing from due times,
model FLOPs, KV bytes per token, the replication bytes the traffic
predicts, and the traffic generator."""
import math
import types

import numpy as np
import pytest

from servebench import bench, flops, stats, workload

YI = bench.load_json(bench.HERE / "configs" / "yi-9b.json")["model"]
MIX = bench.load_json(bench.HERE / "configs" / "mixtral-8x7b-l16.json")["model"]


def req(due, first, finish=-1.0, generated=0, admit=-1.0):
    return {"due": due, "first": first, "finish": finish,
            "generated": generated, "admit": admit, "gen_open": 0,
            "gen_close": generated}


def record(requests, t_open=100.0, t_close=110.0):
    return types.SimpleNamespace(requests=requests, t_open=t_open,
                                 t_close=t_close)


@pytest.mark.parametrize("values, q, want", [
    ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 90, 9),
    ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 50, 5),
    ([5], 90, 5),
    (list(range(1, 21)), 90, 18),
    ([3, 1, 2], 100, 3),
])
def test_nearest_rank_percentile(values, q, want):
    assert stats.percentile(values, q) == want


def test_percentile_counts_failures_as_infinitely_late():
    # 10 requests, 2 never got a first token: the p90 is the 9th smallest,
    # which is infinite
    reqs = [req(100.0 + i, 101.0 + i) for i in range(8)] + \
           [req(108.0, -1.0), req(109.0, -1.0)]
    rec = record(reqs)
    ttfts = [stats.ttft(r) for r in stats.due_in_window(rec)]
    assert stats.percentile(ttfts, 90) == math.inf
    assert stats.percentile(ttfts, 80) == pytest.approx(1.0)
    assert stats.percentile([], 90) is None


def test_ttft_runs_from_the_due_time_not_the_send():
    # due at 100 s, sent late at 103 s, first token at 104 s: 4 s
    assert stats.ttft(req(100.0, 104.0)) == pytest.approx(4.0)


def test_only_requests_due_inside_the_window_count():
    rec = record([req(99.0, 100.0), req(100.0, 101.0), req(109.9, 111.0),
                  req(110.0, 112.0)])
    assert [r["due"] for r in stats.due_in_window(rec)] == [100.0, 109.9]


def test_tpot_hand_count():
    # 11 tokens: the first at 10 s, the last at 12 s -> 0.2 s a token
    assert stats.tpot(req(0.0, 10.0, 12.0, 11)) == pytest.approx(0.2)
    assert stats.tpot(req(0.0, 10.0, -1.0, 11)) is None
    assert stats.tpot(req(0.0, 10.0, 10.0, 1)) is None


def test_kv_bytes_per_token():
    # 2 (K and V) x kv heads x head dim x 2 bytes x layers
    assert flops.kv_bytes_per_token(YI) == 2 * 4 * 128 * 2 * 48 == 98_304
    assert flops.kv_bytes_per_token(MIX) == 2 * 8 * 128 * 2 * 16 == 65_536


def test_active_params_hand_count():
    d, f, v = 4096, 11008, 64000
    attn = d * 4096 + 2 * d * 512 + 4096 * d
    assert flops.active_matmul_params(YI) == 48 * (attn + 3 * d * f) + d * v
    f = 14336
    attn = d * 4096 + 2 * d * 1024 + 4096 * d
    assert flops.active_matmul_params(MIX) == \
        16 * (attn + 2 * 3 * d * f + d * 8) + d * 32000


def test_model_flops_hand_count():
    m = dict(arch_type="dense", n_layers=2, d_model=4, n_heads=2,
             n_kv_heads=1, head_dim=2, d_ff=8, vocab_size=10, n_experts=0,
             top_k=0)
    p = 2 * (4 * 4 + 2 * 4 * 2 + 4 * 4 + 3 * 4 * 8) + 4 * 10     # 296
    assert flops.active_matmul_params(m) == p
    # decode token at position 5 attends 6 keys: 4 * H * D * 6 * layers
    assert flops.token_flops(m, 5) == 2 * p + 4 * 2 * 2 * 6 * 2
    # a 3-token prompt: positions 0..2 attend 1+2+3 keys; one unembedding
    per_attn = 4 * 2 * 2 * 2
    assert flops.prompt_flops(m, 3) == \
        2 * (p - 40) * 3 + 2 * 40 + per_attn * 6
    # tokens 2..4 of a 3-token prompt decode at positions 3, 4, 5
    assert flops.decode_flops(m, 3, 1, 4) == sum(
        flops.token_flops(m, q) for q in (3, 4, 5))
    assert flops.decode_flops(m, 3, 0, 1) == 0        # the prefill's token


def test_window_caps_attended_keys():
    assert flops.attended(MIX, 10_000) == 4096
    assert flops.attended(MIX, 99) == 100
    assert flops.attended(YI, 10_000) == 10_001


def test_decode_kv_bytes_hand_count():
    # prompt 10: tokens 2 and 3 attend 11 and 12 positions
    assert flops.decode_kv_bytes(YI, 10, 1, 3) == (11 + 12) * 98_304


def test_replication_bytes_the_traffic_predicts():
    # (1536 + 48) / 48 tokens of KV per output token (before clipping)
    assert flops.replication_bytes_per_token(YI, 1536, 48) == \
        pytest.approx(33 * 98_304)
    assert flops.replication_bytes_per_token(MIX, 220, 64) == \
        pytest.approx(284 / 64 * 65_536)


TRAFFIC = {"loop": "open", "rate_rps": 2.0, "schedule_seed": 26,
           "prompt": {"mean": 1536, "sigma": 0.6, "min": 512, "max": 2816},
           "output": {"mean": 48, "sigma": 0.4, "min": 16, "max": 128}}


def test_every_seed_replays_one_schedule_with_its_own_tokens():
    a = workload.plan(TRAFFIC, 2**31 + 11, 51.0, 64000)
    b = workload.plan(TRAFFIC, 7, 51.0, 64000)
    assert len(a) == len(b) == 102
    assert [(p.due, len(p.prompt), p.max_new) for p in a] == \
        [(p.due, len(p.prompt), p.max_new) for p in b]
    assert [p.prompt for p in a] != [p.prompt for p in b]
    assert a[0].due == 0.0 and a[-1].due < 51.0
    assert [p.prompt for p in workload.plan(TRAFFIC, 7, 51.0, 64000)] == \
        [p.prompt for p in b]


def test_another_schedule_seed_orders_the_same_work():
    a = workload.plan(TRAFFIC, 7, 51.0, 64000)
    b = workload.plan(dict(TRAFFIC, schedule_seed=27), 7, 51.0, 64000)
    assert sorted(len(p.prompt) for p in a) == sorted(len(p.prompt) for p in b)
    assert sorted(p.max_new for p in a) == sorted(p.max_new for p in b)
    assert [len(p.prompt) for p in a] != [len(p.prompt) for p in b]
    gaps_a = np.sort(np.diff([p.due for p in a]))
    gaps_b = np.sort(np.diff([p.due for p in b]))
    # the same multiset of gaps, less the one each order puts first
    assert abs(gaps_a.sum() - gaps_b.sum()) < 1.0


def test_lengths_follow_the_copied_lognormal():
    rng = np.random.default_rng(0)
    spec = {"mean": 220, "sigma": 0.6, "min": 1, "max": 10**9}
    x = workload.lognormal_lengths(rng, 4000, spec)
    assert x.mean() == pytest.approx(220, rel=0.01)
    clipped = workload.lognormal_lengths(rng, 500, TRAFFIC["prompt"])
    assert clipped.min() >= 512 and clipped.max() <= 2816


def test_warmup_covers_every_bucket_the_traffic_reaches():
    assert workload.warmup_prompt_lengths(TRAFFIC, 16) == [512, 1024, 2048,
                                                           2816]
    chat = {"prompt": {"min": 16, "max": 1024}}
    assert workload.warmup_prompt_lengths(chat, 16) == \
        [16, 32, 64, 128, 256, 512, 1024]


def test_kill_cells_schedule_kills_while_every_request_decodes():
    """The kill of ``rag-kill`` falls where the fixed schedule has no
    arrival for some seconds before it and after its rejoin."""
    traffic = bench.load_json(bench.HERE / "traffic" / "rag-kill.json")
    due = [p.due for p in workload.plan(traffic, 1, 51.0, 64000)]
    kill = traffic["kill"]["at_frac"] * 51.0
    rejoin = kill + traffic["kill"]["rejoin_delay_s"]
    before = max(d for d in due if d < kill)
    after = min(d for d in due if d > kill)
    assert kill - before > 2.5 and after - rejoin > 0.4


@pytest.mark.parametrize("kill, migrations, ok", [
    ({"at_frac": 0.5}, [0, 0], False),
    ({"at_frac": 0.5}, [0, 1], True),
    (None, [0, 0], True),
])
def test_kill_cell_check_needs_a_resumed_request(kill, migrations, ok):
    from servebench import check
    config = {"engine": {"max_seq": 64, "replicate": False},
              "check": {"max_logit_gap": 0.25, "min_tokens": 2}}
    rec = types.SimpleNamespace(traffic={"kill": kill})
    reqs = [{"prompt_len": 4, "max_new": 3, "output": [1, 2, 3],
             "migrations": m} for m in migrations]
    out = check.verdict(config, rec, reqs, [np.zeros(3)] * len(reqs))
    assert all(c["ok"] for c in out.values()) == ok
    assert ("resumed_compared" in out) == (kill is not None)


@pytest.mark.parametrize("replicas, ok", [
    (None, False),                          # never read back
    ({"compared": 0, "differing": 0, "missing": 0}, False),
    ({"compared": 40, "differing": 0, "missing": 0}, True),
    ({"compared": 40, "differing": 1, "missing": 0}, False),
    ({"compared": 40, "differing": 0, "missing": 3}, False),
])
def test_replicating_cell_check_reads_the_replicas_back(replicas, ok):
    from servebench import check
    config = {"engine": {"max_seq": 64, "replicate": True},
              "check": {"max_logit_gap": 0.25, "min_tokens": 2}}
    rec = types.SimpleNamespace(traffic={"kill": None}, replicas=replicas)
    reqs = [{"prompt_len": 4, "max_new": 3, "output": [1, 2, 3],
             "migrations": 0}]
    out = check.verdict(config, rec, reqs, [np.zeros(3)])
    assert all(c["ok"] for c in out.values()) == ok
    assert {"replica_blocks_compared", "replica_blocks_differing",
            "replica_blocks_missing"} <= set(out)
