"""The port's prefill/decode disaggregation (``EngineConfig.disaggregate``):
prefill-role instances run chunked prefill only and stream each finished
page over the replication transport to a decode-role peer, which seats the
request when the final chunk's pages land. Held against the reference
engine on converted weights (streams and every ``disagg_stats`` /
``prefix_stats`` key), and — torch against torch — a PLACEMENT change,
never a numerics change: token streams and raw prompt-page bytes (int8
payload + scales when quantized) equal colocated serving, and the streams
survive killing either side of the handoff mid-flight."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers on few cores
torch.set_num_threads(1)
import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_numpy  # noqa: E402
from repro_torch.serving.engine import EngineConfig, RealEngine  # noqa: E402
from repro_torch.serving.request import Request, RequestState  # noqa: E402

F32 = dict(dtype="float32", kv_dtype="float32")


def _mk_reqs(cfg, lens, out, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt_len=n, max_new_tokens=out,
                    arrival_time=0.0,
                    prompt_tokens=rng.integers(1, cfg.vocab_size, n).tolist())
            for i, n in enumerate(lens)]


def _engine(kv_quant=False, n_instances=2, arch="llama3-8b", **kw):
    cfg = get_config(arch).reduced()
    return RealEngine(cfg, EngineConfig(max_slots=4, max_seq=64,
                                        prefill_chunk=8, kv_quant=kv_quant,
                                        **kw),
                      n_instances=n_instances, seed=0, device="cpu")


# -- the port against the reference engine -------------------------------------

PARITY = {"disagg": dict(),
          "disagg_prefix_int8": dict(prefix_cache=True, kv_quant=True),
          # the hybrid: each handoff carries the request's state blob
          "hybrid_disagg": dict(arch="recurrentgemma-9b")}


def _parity_prompts(vocab):
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab, 16).tolist()
    return [shared + rng.integers(1, vocab, 11).tolist(),
            rng.integers(1, vocab, 8).tolist(),
            shared + [100, 101],
            shared[:12] + [5, 6, 7, 8, 9],
            rng.integers(1, vocab, 27).tolist()]


def _serve_parity(eng, cls, prompts):
    def req(rid, p):
        return cls(rid=rid, prompt_len=len(p), max_new_tokens=6,
                   arrival_time=0.0, prompt_tokens=list(p))
    eng.submit(req(0, prompts[0]))
    eng.run(300)
    for i, p in enumerate(prompts[1:]):
        eng.submit(req(i + 1, p))
    eng.run(500)
    assert not eng.has_pending()
    return {r.rid: (r.output_tokens, r.instance_id) for r in eng.done}


@pytest.fixture(scope="module", params=sorted(PARITY))
def reference_run(request):
    """One reference run per case (float32 reduced llama3-8b unless the
    case names its arch, 2 instances, replication on, chunks of 8)."""
    kw = dict(PARITY[request.param])
    arch = kw.pop("arch", "llama3-8b")
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **F32)
    ecfg = dict(max_slots=4, max_seq=64, prefill_chunk=8, disaggregate=True,
                **kw)
    jeng = JRealEngine(jcfg, JEngineConfig(**ecfg), n_instances=2, seed=0)
    prompts = _parity_prompts(jcfg.vocab_size)
    streams = _serve_parity(jeng, JRequest, prompts)
    return dict(arch=arch, ecfg=ecfg, prompts=prompts, streams=streams,
                prefix=jeng.prefix_stats(), disagg=jeng.disagg_stats(),
                keys=[sorted(i.pool.prefix_index) for i in jeng.instances],
                params=jax.tree_util.tree_map(np.asarray, jeng.params))


def test_disaggregation_matches_reference_engine(reference_run):
    """Streams, the instance each request finished on, every
    disagg_stats / prefix_stats key and the interned chain keys equal the
    reference engine's."""
    ref = reference_run
    cfg = dataclasses.replace(get_config(ref["arch"]).reduced(), **F32)
    teng = RealEngine(cfg, EngineConfig(**ref["ecfg"]), n_instances=2,
                      device="cpu",
                      params=from_jax_numpy(ref["params"], device="cpu"))
    streams = _serve_parity(teng, Request, ref["prompts"])
    assert streams == ref["streams"]
    assert {inst for _, inst in streams.values()} == {1}
    assert teng.disagg_stats() == ref["disagg"]
    assert teng.prefix_stats() == ref["prefix"]
    assert [sorted(i.pool.prefix_index) for i in teng.instances] == \
        ref["keys"]
    assert teng.disagg_stats()["handoffs_seated"] == len(ref["prompts"])
    if cfg.arch_type == "hybrid":
        assert teng.disagg_stats()["handoff_blobs_total"] == \
            len(ref["prompts"])


# -- torch against torch ---------------------------------------------------------

def _capture_pages(eng, req, kv_quant):
    """Prompt-row page bytes for ``req`` from whichever pool holds it (and,
    on the hybrid, its state blob under the key "blob")."""
    for inst in eng.instances:
        if not inst.alive or req.rid not in inst.pool.live_requests():
            continue
        page = inst.pool.page_size
        pages = {}
        for ref in inst.pool.table(req.rid):
            valid = min(page, req.prompt_len - ref.logical_idx * page)
            if valid <= 0:
                continue
            raw = (inst.pool.read_block_quantized(ref.slot)
                   if kv_quant else inst.pool.read_block(ref.slot))
            pages[ref.logical_idx] = [a[:, :, :valid].clone() for a in raw]
        bref = inst.pool.blob_ref(req.rid)
        if bref is not None:
            pages["blob"] = [a.clone() for a in (
                inst.pool.read_blob_quantized(bref.slot) if kv_quant
                else (inst.pool.read_blob(bref.slot),))]
        return inst.instance_id, pages
    return None, None


def _run(kv_quant, disagg, lens=(27, 8, 27), out=6, capture_rid=0,
         arch="llama3-8b"):
    """Run to completion; snapshot the captured request's prompt pages the
    moment it enters DECODE — on the decode-role peer when disaggregated."""
    eng = _engine(kv_quant, disaggregate=disagg, arch=arch)
    reqs = _mk_reqs(eng.cfg, lens, out)
    for r in reqs:
        eng.submit(r)
    seated_on = pages = None
    for _ in range(500):
        if not eng.has_pending():
            break
        eng.step()
        req = reqs[capture_rid]
        if pages is None and req.state in (RequestState.DECODE,
                                           RequestState.DONE):
            seated_on, pages = _capture_pages(eng, req, kv_quant)
    assert not eng.has_pending()
    assert pages is not None
    return eng, reqs, seated_on, pages


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b",
                                  "recurrentgemma-9b"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_disagg_byte_identical_to_colocated(kv_quant, arch):
    """Disaggregated serving emits the exact token streams of colocated
    serving, and the prompt pages the decode instance received over the
    wire are byte-identical to the pages colocated prefill writes locally
    (raw int8 payload + scales on the int8 pool); dense, MoE and hybrid
    (whose handed-off state blob is the colocated one too, one blob per
    handoff)."""
    _, colo, _, colo_pages = _run(kv_quant, disagg=False, arch=arch)
    eng, dis, seated_on, dis_pages = _run(kv_quant, disagg=True, arch=arch)
    assert [r.output_tokens for r in dis] == \
        [r.output_tokens for r in colo]
    assert all(len(r.output_tokens) == 6 for r in dis)
    blob = {"blob"} if arch == "recurrentgemma-9b" else set()
    assert set(dis_pages) == set(colo_pages) == {0, 1, 2, 3} | blob
    for logical in colo_pages:
        for a, b in zip(colo_pages[logical], dis_pages[logical]):
            assert torch.equal(a, b)
    # the captured request really decoded on the decode-role instance,
    # i.e. the bytes compared above rode the wire
    assert seated_on == 1 and eng.roles[1] == "decode"
    assert eng.handoffs_seated == len(dis)
    assert eng.disagg_stats()["handoff_blocks_total"] > 0
    assert eng.disagg_stats()["handoff_blobs_total"] == \
        (eng.handoffs_seated if blob else 0)


def test_roles_routing_and_stats():
    """Admission goes to prefill-role instances only; every request decodes
    on the decode side; the stats show the roles and the handoff byte
    total is exact (blocks * block_nbytes)."""
    eng = _engine(disaggregate=True)
    reqs = _mk_reqs(eng.cfg, (12, 12, 12), out=4)
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert len(eng.instances[0].requests) == 3
    assert not eng.instances[1].requests
    eng.run(300)
    assert all(r.instance_id == 1 for r in reqs), \
        "every request must finish on the decode-role instance"
    st = eng.disagg_stats()
    assert st["enabled"] and st["roles"] == {0: "prefill", 1: "decode"}
    assert st["handoffs_seated"] == 3 and st["handoffs_in_flight"] == 0
    assert eng.control.view.roles == {0: "prefill", 1: "decode"}
    shipped = eng.transport.shipped["handoff"]
    # 12-token prompts: one full page and one partial page each
    assert shipped.blocks == 6 and shipped.msgs >= 3
    assert st["handoff_bytes_total"] == \
        shipped.blocks * eng.instances[0].pool.block_nbytes
    assert eng.transport.dropped["handoff"].msgs == 0
    # the prefill side ran no decode step: its parked slots were released
    assert not eng.instances[0].requests and not eng.instances[0].prefill_jobs


@pytest.mark.parametrize("kw,n_instances", [
    (dict(prefill_chunk=8), 1),       # one instance: no decode peer
    (dict(prefill_chunk=0), 2),       # pages stream as chunks complete
])
def test_disagg_requires_chunking_and_peers(kw, n_instances):
    cfg = get_config("llama3-8b").reduced()
    with pytest.raises(ValueError):
        RealEngine(cfg, EngineConfig(disaggregate=True, **kw),
                   n_instances=n_instances, device="cpu")


def test_prefix_handoff_interns_instead_of_copies():
    """A prefix-cached page crosses the wire AT MOST ONCE: the first
    request streams its pages and both sides intern them at completion; a
    later request sharing the prefix attaches by reference on the prefill
    side and the handoff sends the CHAIN KEY — the decode side interns its
    existing page (zero copy), so only the non-shared tail page ships."""
    eng = _engine(disaggregate=True, prefix_cache=True, replicate=False)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, eng.cfg.vocab_size, 27).tolist()
    a = Request(rid=0, prompt_len=27, max_new_tokens=4, arrival_time=0.0,
                prompt_tokens=list(prompt))
    eng.submit(a)
    eng.run(300)
    first = eng.transport.shipped["handoff"].blocks
    assert first == 4                    # 3 full prompt pages + tail page
    b = Request(rid=1, prompt_len=27, max_new_tokens=4, arrival_time=0.0,
                prompt_tokens=list(prompt))
    eng.submit(b)
    eng.run(300)
    assert b.output_tokens == a.output_tokens
    assert eng.transport.shipped["handoff"].blocks - first == 1
    # with ring replication off, the shared-page stats are handoff-only:
    # 3 references, 0 copies
    assert eng.repl_shared_refs_total == 3
    assert eng.repl_shared_copies_total == 0
    assert eng.disagg_stats()["handoff_shared_zero_copy_pages"] == 3
    assert eng.prefix_stats()["shared_page_ship_ratio"] <= 1.0
    for inst in eng.instances:
        assert len(inst.pool.prefix_index) == 3


def _chaos_run(kv_quant, kill, n_instances=2, lens=(27, 27, 8), out=8,
               arch="llama3-8b"):
    """Serve with a mid-flight kill: ``kill='prefill'`` fails the streaming
    source once pages have shipped; ``kill='decode'`` fails the handoff
    target before any seat."""
    eng = _engine(kv_quant, n_instances=n_instances, disaggregate=True,
                  arch=arch)
    reqs = _mk_reqs(eng.cfg, lens, out)
    for r in reqs:
        eng.submit(r)
    killed = False
    steps = 0
    while eng.has_pending() and steps < 500:
        eng.step()
        steps += 1
        if not killed and kill == "prefill" and \
                eng.transport.shipped["handoff"].blocks > 0 and \
                eng.instances[0].prefill_jobs:
            eng.fail_instance(0)        # source dies mid-stream
            killed = True
        elif not killed and kill == "decode":
            tgt = next((rec["dst"] for rec in eng._handoffs.values()
                        if rec["dst"] is not None
                        and not rec.get("ready_to_seat")), None)
            if tgt is not None and eng.handoffs_seated == 0:
                eng.fail_instance(tgt)  # target dies holding shipped pages
                killed = True
    assert not eng.has_pending() and killed
    return eng, reqs


@pytest.mark.parametrize("kv_quant", [False, True])
def test_disagg_prefill_kill_chaos_drill(kv_quant):
    """Kill the prefill instance while its pages are mid-stream. The
    survivor holds every page that shipped: on the bf16 pool prefill
    RESUMES from the last streamed page; on the int8 pool (lossy pages
    cannot seed the chunk buffers) the request restarts from scratch —
    either way every token stream equals the failure-free run."""
    _, normal, _, _ = _run(kv_quant, disagg=True, lens=(27, 27, 8), out=8)
    eng, failed = _chaos_run(kv_quant, kill="prefill")
    assert [r.output_tokens for r in failed] == \
        [r.output_tokens for r in normal]
    if kv_quant:
        assert eng.handoff_streams_resumed == 0
        assert any(r.n_retries for r in failed)
    else:
        assert eng.handoff_streams_resumed > 0, \
            "mid-stream prefill death must resume from streamed pages"
        assert any(r.n_retries == 0 and r.n_migrations > 0 for r in failed)
    assert not eng._handoffs
    # with the prefill role gone, the survivor serves colocated
    assert all(r.instance_id == 1 for r in failed)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_hybrid_disagg_prefill_kill_restarts_without_resume(kv_quant):
    """The hybrid (the reference's tests/test_disagg.py hybrid case): the
    RG-LRU state spans every streamed page, so a prefill instance killed
    mid-stream never resumes from the streamed pages — the request
    restarts from scratch — and every stream still equals the failure-free
    run's."""
    arch = "recurrentgemma-9b"
    _, normal, _, _ = _run(kv_quant, disagg=True, lens=(27, 27, 8), out=8,
                           arch=arch)
    eng, failed = _chaos_run(kv_quant, kill="prefill", arch=arch)
    assert [r.output_tokens for r in failed] == \
        [r.output_tokens for r in normal]
    assert eng.handoff_streams_resumed == 0
    assert any(r.n_retries for r in failed)
    assert not eng._handoffs
    assert all(r.instance_id == 1 for r in failed)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_disagg_decode_kill_chaos_drill(kv_quant):
    """Kill the decode target before any request seats (3 instances: the
    stream re-targets the surviving decode peer and replays from the
    source, which lost nothing). Token streams equal the failure-free
    run's."""
    _, normal, _, _ = _run(kv_quant, disagg=True, lens=(27, 27, 8), out=8)
    eng, failed = _chaos_run(kv_quant, kill="decode", n_instances=3)
    assert [r.output_tokens for r in failed] == \
        [r.output_tokens for r in normal]
    assert eng.handoffs_seated >= len(failed)
    assert not eng._handoffs
    assert eng.transport.dropped["handoff"].msgs + \
        eng.handoffs_seated >= len(failed)
    assert {r.instance_id for r in failed} == {2}


def test_decode_kill_with_two_instances_falls_back_to_colocated():
    """Two instances, the decode side killed while it decodes seated
    requests and more handoffs stream to it: the seated victims migrate to
    the prefill instance's replicas, the in-flight handoffs seat locally
    there (roles are soft), and every stream equals the failure-free
    run's."""
    def run(kill):
        eng = _engine(disaggregate=True)
        first = _mk_reqs(eng.cfg, (12, 12), out=16, seed=1)
        later = _mk_reqs(eng.cfg, (27, 20), out=8, seed=2)
        for r in later:
            r.rid += 10
        for r in first:
            eng.submit(r)
        steps, killed = 0, False
        while eng.has_pending() and steps < 500:
            eng.step()
            steps += 1
            if steps == 4:
                for r in later:
                    eng.submit(r)
            if kill and not killed and any(
                    rec["dst"] == 1 for rec in eng._handoffs.values()) and \
                    any(rid in eng.replica_meta
                        for rid in eng.instances[1].requests):
                resumed = eng.fail_instance(1)
                assert resumed
                killed = True
        assert not eng.has_pending() and killed == kill
        return eng, first + later

    _, normal = run(False)
    eng, failed = run(True)
    assert [r.output_tokens for r in failed] == \
        [r.output_tokens for r in normal]
    assert any(r.n_migrations for r in failed)
    assert all(r.n_retries == 0 for r in failed)
    assert all(r.instance_id == 0 for r in failed)
    assert not eng._handoffs
