"""The kernel build cache: a library's name follows its source, every shared
header and the flags. Runs on the CPU; no nvcc is called."""

import pytest

from probpose_code_torch.ops.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "tiles.cuh"\nint a() { return 1; }\n')
    (src / "b.cu").write_text("int b() { return 2; }\n")
    (src / "tiles.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_target_is_stable_when_nothing_changes(csrc):
    first = _build._target("a")
    assert _build._target("a") == first
    assert first.parent == _build.BUILD_DIR and first.name.startswith("liba-") and first.suffix == ".so"


@pytest.mark.parametrize("edit", ["change a header", "add a header", "change the source"])
def test_target_follows_sources_and_headers(csrc, edit):
    before = {n: _build._target(n) for n in ("a", "b")}
    if edit == "change a header":
        (csrc / "tiles.cuh").write_text("#pragma once\n// edited\n")
    elif edit == "add a header":
        (csrc / "more.cuh").write_text("#pragma once\n")
    else:
        (csrc / "a.cu").write_text("int a() { return 3; }\n")
    after = {n: _build._target(n) for n in ("a", "b")}
    assert after["a"] != before["a"]
    # every source is rebuilt after a header changes: the build does not track includes
    assert (after["b"] != before["b"]) == (edit != "change the source")


def test_sources_lists_only_cu_stems(csrc):
    (csrc / "notes.txt").write_text("")
    assert _build.sources() == ["a", "b"]
