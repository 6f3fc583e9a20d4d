"""Decoupled init on the port (the torch counterpart of
``tests/test_decoupled_init.py``): re-forming a pipeline after a failure
builds a ``FamilyExecutor`` over the SAME node-resident parameter tensors
(no weight is materialized again) and a return to a topology seen before
is a cache hit. Reduced llama3-8b on the CPU, where the paged-attention
wrapper runs its plain version."""
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cluster import build_group  # noqa: E402
from repro_torch.core.communicator import CommunicatorManager  # noqa: E402
from repro_torch.models import paged_decode as PD  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving.engine import (EngineConfig,  # noqa: E402
                                        FamilyExecutor)
from repro_torch.serving.kvcache import PagedKVPool  # noqa: E402

PROMPT = 21          # tokens: bucket 32, two pages of 16 written


def _leaves(params):
    out = []
    for v in params.values():
        out += _leaves(v) if isinstance(v, dict) else [v]
    return out


def pipeline_step(cfg, ex, params):
    """One bucketed prefill of a PROMPT-token prompt into a fresh paged
    pool, then one decode step through ``ex``. Returns the decode logits."""
    page = cfg.page_size
    bucket = PD.next_bucket(PROMPT, lo=page)
    tokens = torch.zeros((1, bucket), dtype=torch.int32)
    tokens[0, :PROMPT] = torch.arange(1, PROMPT + 1) % cfg.vocab_size
    logits, k, v = ex.prefill(params, tokens, PROMPT)
    width = bucket // page
    pool = PagedKVPool(width + 1, page, cfg.n_layers, cfg.n_kv_heads,
                       cfg.head_dim, real=True, dtype=PD.kv_dtype(cfg),
                       device="cpu")
    refs = pool.allocate(0, PROMPT + 1)
    n_pages = -(-PROMPT // page)
    pool.write_blocks([r.slot for r in refs[:n_pages]],
                      *PD.pack_pages(k, v, n_pages, page))
    row = [r.slot for r in refs] + [width] * (width - len(refs))
    bt = torch.tensor([row], dtype=torch.int32)
    pos = torch.tensor([PROMPT], dtype=torch.int32)
    first = logits.argmax(-1).to(torch.int32)
    _, out = ex.decode(params, first, pool.k, pool.v, None, None, bt, pos,
                       torch.zeros_like(pos), None)
    return out


def test_reform_reuses_weights_and_executor_cache():
    cfg = get_config("llama3-8b").reduced()
    # "weight load" = materializing params (stands in for the remote
    # fetch); done ONCE, then resident on every node
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    t_weights = time.perf_counter() - t0
    ptrs = [t.data_ptr() for t in _leaves(params)]
    group = build_group(2, 4, kv_blocks_per_node=64)
    for node in group.nodes:
        node.weights = params
    outputs = {}

    def build_executable(nodes):
        # every stage's node holds the same resident weights
        assert all(n.weights is params for n in nodes)
        ex = FamilyExecutor(cfg, EngineConfig(max_slots=1, max_seq=64))
        outputs[tuple(n.node_id for n in nodes)] = pipeline_step(
            cfg, ex, nodes[0].weights)
        return ex

    mgr = CommunicatorManager(build_executable=build_executable)
    t0 = time.perf_counter()
    comm0, _ = mgr.form("llama3-8b", group.instances[0].stage_nodes, 0.0)
    t_initial = time.perf_counter() - t0
    # node (0, 2) fails, donor (1, 2): re-form over node-resident weights
    donor = group.instances[1].home_nodes[2]
    patched = list(group.instances[0].stage_nodes)
    patched[2] = donor
    t0 = time.perf_counter()
    comm1, _ = mgr.form("llama3-8b", patched, 1.0)
    t_reform = time.perf_counter() - t0
    # returning to a previously seen topology is a pure cache hit
    t0 = time.perf_counter()
    comm2, cost2 = mgr.form("llama3-8b", group.instances[0].stage_nodes, 2.0)
    t_cached = time.perf_counter() - t0

    assert comm2 is comm0 and comm2.signature == comm0.signature
    assert mgr.stats == {"forms": 3, "cache_hits": 1, "compiles": 2}
    assert cost2 == mgr.costs.state_store
    assert isinstance(comm1.executable, FamilyExecutor)
    assert t_cached < t_initial          # a cache hit builds and runs nothing
    assert t_reform < t_weights + t_initial + 1.0   # sanity envelope
    # no leaf was materialized again: the same storage throughout
    assert [t.data_ptr() for t in _leaves(params)] == ptrs
    # the patched pipeline computes what the first one did, bit for bit
    a, b = outputs.values()
    assert a.shape == (1, cfg.vocab_size) and torch.isfinite(a).all()
    assert torch.equal(a, b)


def test_reform_requires_resident_weights():
    group = build_group(2, 4)
    mgr = CommunicatorManager()
    group.instances[0].stage_nodes[1].weights_loaded = False
    with pytest.raises(AssertionError, match="decoupled init violated"):
        mgr.form("llama3-8b", group.instances[0].stage_nodes, 0.0)
