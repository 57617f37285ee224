"""Tiny cells for the CPU tests: a temporary copy of the benchmark with
tiny configurations, mixes and limits added as new files and entries."""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import shutil
from pathlib import Path

from portbench import core

TINY_DATA = {"users": 3000, "items": 8000, "draws": 60000, "clusters": 64}


def tiny_copy(tmp: Path) -> Path:
    """``tmp/BENCHMARK.json`` and ``tmp/portbench/`` with the cells
    ``tiny-mf.fit`` and ``tiny-mf.eval`` added."""
    shutil.copytree(core.BENCH_DIR, tmp / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = core.load_json(core.REPO / "BENCHMARK.json")
    base = core.load_json(core.BENCH_DIR / "configs" / "warp-mf-d64.json")
    cfg = dict(base, name="tiny-mf", data=TINY_DATA, fit={"epochs": 1, "pool_size": 16384})
    cfg["model"] = dict(base["model"], batch_size=4096, fast_path="on")
    (tmp / "portbench" / "configs" / "tiny-mf.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-mf", "source": "https://github.com/lyst/lightfm",
                             "file": "portbench/configs/tiny-mf.json", "reduced": [],
                             "why": "tiny"})
    mix = {"driver": "eval", "test_users": 500, "items_per_user": 10, "trace_requests": 2}
    (tmp / "portbench" / "traffic" / "eval-tiny.json").write_text(json.dumps(mix))
    for cell, config, traffic, real in (
            ("tiny-mf.fit", "tiny-mf", "fit", "warp-mf-d64.fit"),
            ("tiny-mf.eval", "tiny-mf", "eval-tiny", "warp-mf-d64.eval")):
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "tiny"})
        shutil.copy(core.BENCH_DIR / "limits" / f"{real}.json",
                    tmp / "portbench" / "limits" / f"{cell}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def cell(root: Path, name: str) -> core.Cell:
    return core.Cell(name, bench_file=root / "BENCHMARK.json", bench_dir=root / "portbench")


def run_cell(root: Path, name: str, seed: int = 20240601, seconds: float = 6.0,
             trace: int = 0):
    """One run of a tiny cell on the CPU through ``run.measure``; returns
    ``(exit code, stdout lines, parsed last line)``."""
    import torch

    from portbench import run

    c = cell(root, name)
    driver = importlib.import_module(f"portbench.drivers.{c.traffic['driver']}")
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds, trace=trace)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.measure(args, c, driver, torch.device("cpu"))
    lines = buf.getvalue().splitlines()
    return rc, lines, (json.loads(lines[-1]) if lines else None)
