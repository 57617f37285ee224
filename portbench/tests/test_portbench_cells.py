"""Every cell of BENCHMARK.json finds its files by name, the file keeps the
benchmark's contract, and a cell added as new files and entries runs."""

import json
import re

import pytest

from portbench import core
from _tiny import run_cell, tiny_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = core.load_json(core.REPO / "BENCHMARK.json")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_configuration_mix_limits_and_readers(name):
    cell = core.Cell(name)
    assert cell.config["model"] and cell.traffic["driver"] in ("fit", "eval")
    assert cell.limits
    e2e = {m["name"] for m in cell.metrics("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = cell.metrics("per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e
        assert callable(cell.reader(m["name"]).read)


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (core.REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.add(w["name"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_configuration_mix_and_metric_added_as_files_and_entries_run(tmp_path):
    root = tiny_copy(tmp_path)
    # A new per-layer metric: a reader file and an entry, nothing edited.
    (root / "portbench" / "metrics" / "requests_traced.eval.py").write_text(
        "def read(ctx):\n    return float(ctx['requests']) if ctx.get('requests') else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "requests_traced.eval", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "ranking", "moves": "served_users_per_s",
                               "workloads": ["tiny-mf.eval"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, _, line = run_cell(root, "tiny-mf.eval", trace=1)
    assert rc == 0 and line["correct"]
    assert line["metrics"]["requests_traced.eval"] == {"value": 2.0, "unit": "requests"}
    rc, _, line = run_cell(root, "tiny-mf.eval", trace=0)
    assert rc == 0 and line["correct"]
    assert set(line["metrics"]) == {"served_users_per_s", "request_p95_ms", "setup_s"}
