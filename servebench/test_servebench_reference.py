"""The plain references against the port's CPU path, on weights the
benchmark draws from a seed, at a reduced size in float32 (weights, pool
and activations), where the two must agree to float32 rounding: the
prefill's last logits, and every token the engine serves greedily lies on
the reference's best logit."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from servebench import bench, harness, weights
from servebench import check as CHECK
from servebench.tiny import tiny_cell

# every cell of the benchmark, a cell added later included
CELLS = [w["name"] for w in bench.load_json(bench.BENCHMARK)["workloads"]]


def f32_config(cell_name):
    config = copy.deepcopy(tiny_cell(cell_name).config)
    config["model"].update(dtype="float32", kv_dtype="float32")
    return config


@pytest.mark.parametrize("cell_name", CELLS)
def test_weight_tree_is_the_ports_layout(cell_name):
    from repro_torch.models import api
    config = tiny_cell(cell_name).config
    cfg = harness.port_config(config)
    ours = weights.draw(config["model"], 3, "cpu")
    gen = torch.Generator().manual_seed(0)
    theirs = api.init_params(cfg, gen, device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else (tuple(v.shape),
                                                          v.dtype)
                for k, v in tree.items()}
    assert shapes(ours) == shapes(theirs)


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_matches_port_prefill(cell_name):
    from repro_torch.models import paged_decode as PD
    config = f32_config(cell_name)
    model = config["model"]
    cfg = harness.port_config(config)
    params = weights.draw(model, 2**31 + 3, "cpu")
    rng = np.random.default_rng(5)
    for n in (5, 13, 32):
        toks = rng.integers(1, model["vocab_size"], n).tolist()
        bucket = PD.next_bucket(n, lo=cfg.page_size)
        padded = torch.zeros((1, bucket), dtype=torch.int32)
        padded[0, :n] = torch.tensor(toks)
        port, _, _ = PD.prefill_bucketed(cfg, params, padded, n)
        ref = CHECK.reference_logits(model)(model, params, [toks], [[n - 1]])
        torch.testing.assert_close(ref[0], port.float(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("cell_name", CELLS)
def test_served_tokens_sit_on_the_reference_best(cell_name):
    from repro_torch.serving.server import EngineService
    config = f32_config(cell_name)
    model = config["model"]
    cfg = harness.port_config(config)
    ecfg = dataclasses.replace(harness.engine_config(config, {}),
                               prefill_chunk=config["engine"]["prefill_chunk"])
    params = weights.draw(model, 11, "cpu")
    svc = EngineService(cfg, ecfg, n_instances=2, device="cpu", params=params)
    rng = np.random.default_rng(1)
    try:
        reqs = [svc.submit(rng.integers(1, model["vocab_size"], n).tolist(), 9)
                for n in (7, 20, 41)]
        for r in reqs:
            assert svc.wait(r, timeout=120)
    finally:
        svc.shutdown()
    served = [{"prompt": list(r.prompt_tokens), "prompt_len": r.prompt_len,
               "output": list(r.output_tokens)} for r in reqs]
    gaps = CHECK.served_gaps(model, params, served)
    assert max(g.max() for g in gaps) < 1e-4
    assert sum(len(g) for g in gaps) == 27
