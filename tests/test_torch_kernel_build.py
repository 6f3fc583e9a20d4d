"""The kernel builder's library name: a hash of the CUDA source and of every
local header it includes, so an edited header never loads a stale library.
Runs on the CPU: nothing is compiled."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import paged_attention_int8 as PA8  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source tree: k.cu includes a.cuh (quoted) and a system header;
    a.cuh includes b.cuh; c.cuh is included by nothing."""
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\nint f() { return g(); }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  # include "b.cuh"\n'
                                    "inline int g() { return h(); }\n")
    (tmp_path / "b.cuh").write_text("inline int h() { return 1; }\n")
    (tmp_path / "c.cuh").write_text("inline int u() { return 2; }\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_sources_follow_local_includes(csrc):
    lib = build.KernelLibrary("k", bind=None)
    assert [p.name for p in lib.sources()] == ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("edited,changes", [
    ("k.cu", True), ("a.cuh", True), ("b.cuh", True), ("c.cuh", False)])
def test_library_path_changes_with_an_included_header(csrc, edited,
                                                     changes):
    lib = build.KernelLibrary("k", bind=None)
    before = lib.library_path()
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    assert (lib.library_path() != before) == changes
    assert lib.library_path().parent == build.BUILD_DIR


def test_attention_libraries_hash_their_shared_header():
    common = build.CSRC / "paged_attention_common.cuh"
    for mod in (PA, PA8):
        assert common in mod.LIB.sources()
    assert SSD.LIB.sources() == [SSD.LIB.source]
