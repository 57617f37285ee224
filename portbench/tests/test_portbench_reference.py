"""The reference imports nothing of the repository or of JAX, the run
guards its process, and a run without a card fails without a result."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import core

BANNED = {"jax", "jaxlib", "flax", "lightfm_tpu", "lightfm_tpu_torch"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((core.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_neither_jax_nor_the_repositorys_packages(path):
    assert not _top_level_imports(path) & BANNED


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lightfm_tpu_torch_lookalike", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lightfm_tpu.model", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert core.forbidden_modules() == ["jax", "lightfm_tpu"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(core.BENCH_DIR / "run.py"), "--workload", "warp-mf-d64.fit",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=core.REPO)
    assert out.returncode != 0 and "{" not in out.stdout
    assert "CUDA device" in out.stderr


def test_run_in_a_folder_without_the_port_fails(tmp_path):
    import shutil

    shutil.copy(core.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(core.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "warp-mf-d64.eval", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout
