"""The kernel build's cache key and what it compiles (lightfm_tpu_torch.ops._build), on the CPU.

No ``nvcc`` runs here: the target name is a pure function of the sources,
and ``build_all`` is driven with a stand-in compiler process and loader.
"""

import ctypes
import subprocess

import pytest

from lightfm_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source tree of one kernel source and one shared header."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text('#include "shared.cuh"\n__global__ void k() {}\n')
    (src / "shared.cuh").write_text("#pragma once\nconstexpr int kSeg = 64;\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    return src


def test_target_follows_the_source_and_every_header(csrc):
    cu = csrc / "kern.cu"
    first = _build._target(cu)
    assert first.parent == _build.BUILD_DIR and first.name.startswith("kern_")
    assert _build._target(cu) == first  # nothing changed: the same library
    (csrc / "shared.cuh").write_text("#pragma once\nconstexpr int kSeg = 32;\n")
    edited = _build._target(cu)
    assert edited != first  # an edited header rebuilds
    (csrc / "other.cuh").write_text("#pragma once\n")
    assert _build._target(cu) not in (first, edited)  # so does a new one
    (csrc / "other.cuh").unlink()
    assert _build._target(cu) == edited
    cu.write_text(cu.read_text() + "// edited\n")
    assert _build._target(cu) != edited  # and an edited source


def test_build_log_follows_the_target(csrc):
    target = _build._target(csrc / "kern.cu")
    target.parent.mkdir(parents=True)
    target.with_suffix(".log").write_text("ptxas info : Used 40 registers\n")
    assert "40 registers" in _build.build_log("kern")
    (csrc / "shared.cuh").write_text("#pragma once\n")
    assert _build.build_log("kern") == ""  # the edited header's build has no log yet


def test_build_all_compiles_only_the_sources(csrc, monkeypatch):
    compiled, loaded = [], []

    class FakeNvcc:
        def __init__(self, argv, stdout, stderr):
            compiled.append(argv[-1])
            open(argv[argv.index("-o") + 1], "wb").close()

        def wait(self):
            return 0

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: loaded.append(path) or path)
    libs = _build.build_all()
    assert compiled == [str(csrc / "kern.cu")]  # the header is not a library
    assert list(libs) == ["kern"] and loaded == [str(_build._target(csrc / "kern.cu"))]
    _build._LIBS.clear()
    _build.build_all()  # an unchanged tree reuses its library
    assert len(compiled) == 1 and len(loaded) == 2
