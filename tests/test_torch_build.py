"""The kernel build cache: a library's name follows its source, every shared
header and the flags, a source's own flags (``SOURCE_FLAGS``) included. Runs
on the CPU; no nvcc is called."""

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


def test_source_flags_are_part_of_the_hash(csrc, monkeypatch):
    before = {n: _build._target(n) for n in ("a", "b")}
    monkeypatch.setattr(_build, "SOURCE_FLAGS", {"a": ["-lnvjpeg"]})
    assert _build.flags("a") == _build.NVCC_FLAGS + ["-lnvjpeg"] and _build.flags("b") == _build.NVCC_FLAGS
    after = {n: _build._target(n) for n in ("a", "b")}
    assert after["a"] != before["a"] and after["b"] == before["b"]
    monkeypatch.setattr(_build, "SOURCE_FLAGS", {"a": ["-lnvjpeg", "-Xlinker", "-rpath=/elsewhere"]})
    assert _build._target("a") != after["a"]


def test_only_the_nvjpeg_yardstick_links_nvjpeg():
    assert {"jpeg_decode", "nvjpeg_batched"} <= set(_build.sources())
    assert "-lnvjpeg" in _build.flags("nvjpeg_batched")
    assert all("-lnvjpeg" not in _build.flags(n) for n in _build.sources() if n != "nvjpeg_batched")


def test_nvcc_is_given_the_hashed_flags(csrc, monkeypatch):
    """The command that builds a source carries exactly ``flags(name)``,
    the flags its library's name hashes, after the source."""
    commands = []
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", lambda cmd, **kw: commands.append(cmd))
    monkeypatch.setattr(_build, "SOURCE_FLAGS", {"a": ["-lnvjpeg", "-Xlinker", "-rpath=/elsewhere"]})
    for name in ("a", "b"):
        (_, tmp), out = _build._start(name)
        assert out == _build._target(name)
        assert commands[-1] == ["nvcc", str(csrc / f"{name}.cu"), "-o", str(tmp), *_build.flags(name)]
    assert commands[0][-3:] == ["-lnvjpeg", "-Xlinker", "-rpath=/elsewhere"]
