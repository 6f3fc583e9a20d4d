"""Model families are found by name (``families/<arch_type>.py``): the two
families the benchmark has draw the same weights bit for bit, give the same
reference logits and count the same work as before they moved out of
``weights.py``, ``check.py``, ``flops.py`` and ``tiny.py`` (values in
``recorded_before_families.json``, taken from those files by this file's
``weights_digest``, ``logits_summary`` and ``flops_table``), and a family
added as new files alone is what draw, reference, CPU cut and work counts
resolve to."""
import hashlib
import importlib
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from servebench import bench, families, flops, weights
from servebench import check as CHECK
from servebench.tiny import tiny_cell

RECORDED = bench.load_json(bench.HERE / "recorded_before_families.json")
BENCH = bench.load_json(bench.BENCHMARK)
# a cell of each configuration, whose tiny cut the recorded trees are of
CELL_OF = {"yi-9b": "yi9b-rag-kill", "mixtral-8x7b-l16": "mixtral16-chat-batch"}
PROMPTS = (1, 16, 100, 512, 1536, 2816, 5000)
OVERRIDABLE = ["attention_matmul_params", "active_matmul_params", "attended",
               "attention_flops", "token_flops", "prompt_flops",
               "decode_flops", "kv_bytes_per_token_layer",
               "kv_bytes_per_token", "decode_kv_bytes",
               "replication_bytes_per_token"]
# arguments after the model block, for each overridable function
ARGS = {"attended": (100,), "attention_flops": (100,), "token_flops": (100,),
        "prompt_flops": (100,), "decode_flops": (100, 0, 48),
        "decode_kv_bytes": (100, 0, 48),
        "replication_bytes_per_token": (100, 48)}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def weights_digest(tree):
    """sha256 over every leaf's name, shape, dtype and bytes (in name
    order), and the sum of all leaves in float64."""
    h, total = hashlib.sha256(), 0.0
    for name, t in _leaves(tree):
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode() + str(t.dtype).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
        total += float(t.double().sum())
    return h.hexdigest(), total


def logits_summary(model):
    """The reference's logits at every position of three sequences, on
    float32 weights of seed 2**31 + 3."""
    m32 = dict(model, dtype="float32", kv_dtype="float32")
    params = weights.draw(m32, 2**31 + 3, "cpu")
    rng = np.random.default_rng(5)
    seqs = [rng.integers(1, m32["vocab_size"], n).tolist() for n in (5, 13, 32)]
    ref = CHECK.reference_logits(m32)(m32, params, seqs,
                                      [range(len(s)) for s in seqs])
    x = torch.cat(ref).double()
    return {"sum": float(x.sum()), "sumsq": float((x * x).sum()),
            "head": x[0, :4].tolist(), "argmax": x.argmax(-1).tolist()}


def flops_table(model):
    f = {"active_matmul_params": flops.active_matmul_params(model),
         "kv_bytes_per_token_layer": flops.kv_bytes_per_token_layer(model),
         "kv_bytes_per_token": flops.kv_bytes_per_token(model)}
    for p in PROMPTS:
        f[f"attended/{p}"] = flops.attended(model, p)
        f[f"attention_flops/{p}"] = flops.attention_flops(model, p)
        f[f"token_flops/{p}"] = flops.token_flops(model, p)
        f[f"prompt_flops/{p}"] = flops.prompt_flops(model, p)
        f[f"decode_flops/{p}/0/48"] = flops.decode_flops(model, p, 0, 48)
        f[f"decode_flops/{p}/5/40"] = flops.decode_flops(model, p, 5, 40)
        f[f"decode_kv_bytes/{p}/0/48"] = flops.decode_kv_bytes(model, p, 0, 48)
        f[f"replication_bytes_per_token/{p}/48"] = \
            flops.replication_bytes_per_token(model, p, 48)
    return f


def full_model(config_name):
    return bench.load_json(bench.HERE / "configs"
                           / f"{config_name}.json")["model"]


@pytest.mark.parametrize("config_name", sorted(CELL_OF))
@pytest.mark.parametrize("seed", [3, 2**31 + 3])
def test_drawn_weights_are_bit_identical_to_the_recorded(config_name, seed):
    model = tiny_cell(CELL_OF[config_name]).config["model"]
    want = RECORDED["weights"][f"{config_name}/{seed}"]
    sha, total = weights_digest(weights.draw(model, seed, "cpu"))
    assert sha == want["sha256"]
    assert total == want["sum"]


@pytest.mark.parametrize("config_name", sorted(CELL_OF))
def test_reference_logits_are_the_recorded(config_name):
    got = logits_summary(tiny_cell(CELL_OF[config_name]).config["model"])
    want = RECORDED["logits"][config_name]
    assert got["argmax"] == want["argmax"]
    # float32 sums over the same operations: equal up to the CPU's own
    # choice of summation order across thread counts
    for key in ("sum", "sumsq"):
        assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-4)
    assert got["head"] == pytest.approx(want["head"], rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("config_name", sorted(CELL_OF))
def test_work_counts_are_the_recorded(config_name):
    assert flops_table(full_model(config_name)) == \
        RECORDED["flops"][config_name]


def test_every_configuration_has_its_family():
    for c in BENCH["configs"]:
        model = bench.load_json(bench.ROOT / c["file"])["model"]
        fam = families.load(model)
        assert all(callable(getattr(fam, n, None))
                   for n in ("draw", "logits", "tiny"))


def test_overridable_functions_are_the_documented():
    found = sorted(n for n in dir(flops)
                   if callable(getattr(getattr(flops, n), "default", None)))
    assert found == sorted(OVERRIDABLE)
    doc = families.__doc__
    assert all(f"``{n}``" in doc for n in OVERRIDABLE)


def test_a_missing_family_names_its_path(tmp_path, monkeypatch):
    monkeypatch.setattr(families, "__path__", [str(tmp_path)])
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "no_such.py")):
        weights.draw({"arch_type": "no-such"}, 1, "cpu")


@pytest.mark.parametrize("use", ["draw", "logits", "tiny", "flops"])
def test_a_block_without_a_family_is_an_error_everywhere(use):
    model = dict(full_model("yi-9b"))
    del model["arch_type"]
    with pytest.raises(KeyError, match="arch_type"):
        if use == "draw":
            weights.draw(model, 1, "cpu")
        elif use == "logits":
            CHECK.reference_logits(model)
        elif use == "tiny":
            families.load(model).tiny(model)
        else:
            flops.token_flops(model, 100)


TOY = '''
"""A toy family: what each function returns marks it as the toy's."""
import torch

MARK = 7.0


def draw(model, seed, device):
    return {"toy": torch.full((2,), float(seed), device=device)}


def logits(model, params, seqs, wanted, *, precision="f32"):
    return [torch.full((len(w), model["vocab_size"]), MARK) for w in wanted]


def tiny(model):
    return dict(model, n_layers=1, toy_cut=True)
'''


def _toy_tree(tmp_path, monkeypatch, extra=""):
    """A copy of the benchmark's files with a toy family, its configuration
    and a cell added as new files and entries; nothing else differs."""
    sb = tmp_path / "servebench"
    shutil.copytree(bench.HERE, sb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (sb / "families" / "toy_arch.py").write_text(TOY + extra)
    cfg = bench.load_json(sb / "configs" / "yi-9b.json")
    cfg["name"] = "toy-model"
    cfg["model"]["arch_type"] = "toy-arch"
    (sb / "configs" / "toy-model.json").write_text(json.dumps(cfg))
    b = json.loads(json.dumps(BENCH))
    b["configs"].append({"name": "toy-model", "source": "https://example.org",
                         "file": "servebench/configs/toy-model.json",
                         "reduced": [], "why": "a family as new files"})
    b["workloads"].append({"name": "toy-cell", "config": "toy-model",
                           "traffic": "rag-kill", "chips": 1, "why": "toy"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    # the copy's families first; each test imports its own toy afresh
    monkeypatch.setattr(families, "__path__",
                        [str(sb / "families"), *families.__path__])
    monkeypatch.delitem(sys.modules, "servebench.families.toy_arch",
                        raising=False)
    importlib.invalidate_caches()
    added = {sb / "families" / "toy_arch.py", sb / "configs" / "toy-model.json"}
    for path in sb.rglob("*"):
        if path.is_file() and path not in added:
            assert path.read_bytes() == \
                (bench.HERE / path.relative_to(sb)).read_bytes()
    return cfg["model"]


def test_a_family_added_as_files_alone_is_found(tmp_path, monkeypatch):
    model = _toy_tree(tmp_path, monkeypatch)
    cell = tiny_cell("toy-cell", root=tmp_path)
    assert cell.config["model"]["toy_cut"] is True
    assert cell.config["model"]["n_layers"] == 1
    tree = weights.draw(model, 5, "cpu")
    assert tree["toy"].tolist() == [5.0, 5.0]
    fn = CHECK.reference_logits(model)
    assert fn(model, tree, [[1, 2]], [[0, 1]])[0].eq(7.0).all()
    # the served gaps read the toy's reference
    gaps = CHECK.served_gaps(model, tree, [{"prompt": [1, 2], "prompt_len": 2,
                                            "output": [3, 4]}])
    assert gaps[0].tolist() == [0.0, 0.0]
    # no work count is the toy's: each is the formula's
    for name in OVERRIDABLE:
        fn = getattr(flops, name)
        assert fn(model, *ARGS.get(name, ())) == \
            fn.default(model, *ARGS.get(name, ()))


TOY_COUNT = 123_456_789
# a formula that builds on an overridden count, and what it then gives
BUILDS_ON = {
    "active_matmul_params": ("token_flops", lambda m: 2 * TOY_COUNT
                             + flops.attention_flops(m, 100)),
    "attention_flops": ("token_flops", lambda m: 2 * flops.active_matmul_params(m)
                        + TOY_COUNT),
    "attended": ("attention_flops", lambda m: 4 * m["n_heads"] * m["head_dim"]
                 * TOY_COUNT * m["n_layers"]),
    "kv_bytes_per_token": ("replication_bytes_per_token",
                           lambda m: (100 + 48) / 48 * TOY_COUNT),
}


@pytest.mark.parametrize("name", OVERRIDABLE)
def test_a_family_work_count_replaces_the_formula(name, tmp_path,
                                                  monkeypatch):
    extra = f"\n\ndef {name}(model, *args):\n    return {TOY_COUNT}\n"
    model = _toy_tree(tmp_path, monkeypatch, extra)
    assert getattr(flops, name)(model, *ARGS.get(name, ())) == TOY_COUNT
    if name in BUILDS_ON:
        other, want = BUILDS_ON[name]
        assert getattr(flops, other)(model, *ARGS.get(other, ())) == \
            want(model)
    # a model block of another family is untouched
    yi = full_model("yi-9b")
    fn = getattr(flops, name)
    assert fn(yi, *ARGS.get(name, ())) == fn.default(yi, *ARGS.get(name, ()))


def test_family_modules_are_loaded_once():
    model = full_model("yi-9b")
    assert families.load(model) is families.load(dict(model))
    # one module however it is reached: moe.py's import of dense.py is it
    from servebench.families import moe
    assert moe.dense is families.load(model)
    assert sys.modules[families.module_name(model)] is families.load(model)


@pytest.fixture(autouse=True)
def _no_toy_left_behind():
    yield
    sys.modules.pop("servebench.families.toy_arch", None)
