"""The generic fit cell ``warp-hybrid-l2.fit`` through a tiny copy on the
CPU: its line is correct, the generic path's faults and the bfloat16
control make it false, a program that does not mark its generic step's
parts stops at set-up, and the tag generator keeps its law.  On the card,
the control and every fault at the cell's own size."""

import importlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import core, faults_generic
from portbench.data import tags
from _tiny import TINY_DATA, cell, run_cell, tiny_copy

REAL = "warp-hybrid-l2.fit"
TINY = "tiny-hybrid.fit"
CHECKS = {"grad_norm_gap", "change1_norm_gap", "log_scale_gap", "fold_gap"}


def tiny_hybrid_copy(tmp):
    """``tiny_copy`` with the cell ``tiny-hybrid.fit`` added: the real
    configuration on the tiny data, a batch of 4,096 and 2 epochs, at ten
    times the real cell's limits."""
    root = tiny_copy(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = core.load_json(core.BENCH_DIR / "configs" / "warp-hybrid-l2.json")
    cfg = dict(base, name="tiny-hybrid", data=TINY_DATA, fit={"epochs": 2})
    cfg["model"] = dict(base["model"], batch_size=4096)
    (root / "portbench" / "configs" / "tiny-hybrid.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-hybrid", "source": "https://github.com/lyst/lightfm",
                             "file": "portbench/configs/tiny-hybrid.json", "reduced": [],
                             "why": "tiny"})
    bench["workloads"].append({"name": TINY, "config": "tiny-hybrid", "traffic": "fit-generic",
                               "chips": 1, "why": "tiny"})
    # The tiny cell sums fewer terms a row on the CPU, so its float32 order
    # gaps run up to ten times the card's at the cell's size (change1 3.5e-7
    # against 3.7e-8); its bfloat16 control reads 1.4e-3.
    limits = core.load_json(core.BENCH_DIR / "limits" / f"{REAL}.json")
    (root / "portbench" / "limits" / f"{TINY}.json").write_text(
        json.dumps({k: 10 * v for k, v in limits.items()}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_hybrid_copy(tmp_path_factory.mktemp("bench"))


def _driver_run(root, seed=77):
    c = cell(root, TINY)
    driver = importlib.import_module(f"portbench.drivers.{c.traffic['driver']}")
    return c, driver.Run(c, seed, torch.device("cpu"))


def test_the_cell_is_in_the_benchmark_with_its_metrics():
    c = core.Cell(REAL)
    assert c.chips == 1 and c.traffic["driver"] == "fit_generic"
    assert set(c.limits) == CHECKS
    assert {m["name"] for m in c.metrics("end_to_end")} == {"train_examples_per_s", "setup_s"}
    assert {m["name"] for m in c.metrics("per_layer")} == {
        "mfu.fit", "launches_per_step.fit", "step_score_ms.fit", "step_update_ms.fit", "step_l2_ms.fit", "hybrid_score_roofline.fit",
        "hybrid_update_roofline.fit"}
    for m in c.metrics("per_layer"):
        assert callable(c.reader(m["name"]).read)
    assert c.config["model"]["item_alpha"] == 1e-6 and c.config["model"]["no_components"] == 30


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_line_is_correct(root, trace):
    rc, _, line = run_cell(root, TINY, seed=2**31 + 77, trace=trace)
    assert rc == 0 and line["correct"] is True, line and line["checks"]
    assert set(line["checks"]) == CHECKS
    if trace:
        # A CPU trace holds no device operation, so no reader finds anything.
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {"train_examples_per_s", "setup_s"}


# ``no_scale`` shows only where the scales have grown: a tiny step updates
# 30 times fewer examples, so here it moves the log scales by 2e-6, under the
# tiny limit; at the cell's size (the card test) it reads 9e-5 to 1.5e-4.
TINY_FAULTS = [f for f in faults_generic.FAULTS if f != "no_scale"]


@pytest.mark.parametrize("fault", TINY_FAULTS)
def test_a_run_with_a_generic_fault_under_it_is_not_correct(root, fault):
    with faults_generic.planted(fault):
        rc, _, line = run_cell(root, TINY)
    assert rc == 0 and line["correct"] is False


def test_control_fails_the_cells_limits(root):
    c, run = _driver_run(root)
    run.setup()
    run.window(3.0)
    run.release()
    got, control = run.checks(), run.control()
    assert all(got[k] <= limit for k, limit in c.limits.items())
    assert any(control[k] > limit for k, limit in c.limits.items())


def test_a_program_without_the_generic_step_spans_stops_at_set_up(root, monkeypatch):
    from lightfm_tpu_torch import observability

    monkeypatch.setattr(observability, "span", lambda name: observability._OFF)
    _, run = _driver_run(root)
    with pytest.raises(RuntimeError, match="marks none of"):
        run.setup()


def test_tags_repeat_from_a_seed_and_keep_their_law():
    n_items, seed = 64_000, 5
    a = tags.item_tags(n_items, seed)
    assert (a != tags.item_tags(n_items, seed)).nnz == 0
    assert (a != tags.item_tags(n_items, seed + 1)).nnz > 0
    assert a.shape == (n_items, 2048) and a.has_canonical_format
    assert set(np.unique(a.data)) == {1.0}
    per_item = np.diff(a.indptr)
    assert per_item.min() == 1 and per_item.max() == 5
    assert abs(per_item.mean() - 3.0) < 0.03
    # One topic tag an item, of its cluster's 16.
    topic = a[:, :1024]
    assert (np.diff(topic.indptr) == 1).all()
    cluster = np.arange(n_items) // (n_items // 64)
    assert (topic.indices // 16 == cluster).all()
    # The rest by Zipf popularity: the first draw of a slot follows 1/(k+1)
    # exactly; the top tag lands on about a quarter of the items.
    counts = np.bincount(a.indices[a.indices >= 1024] - 1024, minlength=1024)
    share = counts[0] / n_items
    assert 0.2 < share < 0.3
    assert counts[0] > counts[1] > counts[3] > counts[15] > counts[255]
    ratio = counts[0] / counts[1]
    assert 1.6 < ratio < 2.2


def test_zipf_weights_by_hand():
    p = tags.zipf_weights(4, 1.0)
    h = 1 + 1 / 2 + 1 / 3 + 1 / 4
    np.testing.assert_allclose(p, [1 / h, 1 / (2 * h), 1 / (3 * h), 1 / (4 * h)])


def _readings_on_the_card(*args):
    out = subprocess.run(
        [sys.executable, str(core.BENCH_DIR / "readings_generic.py"), "--workload", REAL,
         *args], capture_output=True, text=True, timeout=1800, cwd=core.REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    return list(map(json.loads, out.stdout.splitlines()))


@pytest.mark.card
def test_control_at_the_cells_size_on_the_card(card):
    limits = core.Cell(REAL).limits
    for line in _readings_on_the_card("--control", "--seeds", "901", "902", "903"):
        assert all(line["program"][k] <= limit for k, limit in limits.items())
        assert any(line["control"][k] > limit for k, limit in limits.items())
    for fault in faults_generic.FAULTS:
        line, = _readings_on_the_card("--fault", fault, "--seeds", "904")
        assert any(line["program"][k] > limit for k, limit in limits.items()), fault
