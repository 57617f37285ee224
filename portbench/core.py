"""What every cell shares: finding a cell's files by name, the metrics a
cell reports, the import guard and the result line."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent

# Top-level module names that must never be loaded in a run: the JAX
# package the port was made from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "lightfm_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    limits, each read from its own file under the benchmark's folder."""

    def __init__(self, name: str, bench_file: Path = REPO / "BENCHMARK.json",
                 bench_dir: Path = BENCH_DIR):
        self.bench = load_json(bench_file)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {bench_file.name}: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.bench_dir = bench_dir
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(bench_file.parent / configs[self.entry["config"]]["file"])
        self.traffic = load_json(bench_dir / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(bench_dir / "limits" / f"{name}.json")

    def metrics(self, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports: an
        end-to-end metric without ``workloads`` is every cell's, a per-layer
        metric lists its cells."""
        if kind == "end_to_end":
            return [m for m in self.bench["end_to_end"]
                    if self.name in m.get("workloads", [self.name])]
        return [m for m in self.bench["per_layer"] if self.name in m["workloads"]]

    def reader(self, metric: str):
        """The per-layer metric's reader module, ``metrics/<name>.py``."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The run's last stdout line; ``checks`` (each compared number with
    its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
