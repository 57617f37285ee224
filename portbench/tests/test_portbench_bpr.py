"""The cells ``bpr-adagrad-l2.fit-partial`` and ``warp-mf-d64.eval-fresh``
through a tiny copy on the CPU: their lines are correct, traced and
untraced; the BPR faults and the bfloat16 control fail the fit cell's
limits, the TF32 control the eval-fresh cell's; every eval-fresh call
passes a test matrix no earlier call passed.  On the card, the controls and
every fault at the cells' own size."""

import importlib
import json
import subprocess
import sys

import pytest
import torch

from portbench import core, faults_bpr
from _tiny import TINY_DATA, cell, run_cell, tiny_copy

FIT, FRESH = "bpr-adagrad-l2.fit-partial", "warp-mf-d64.eval-fresh"
TINY_FIT, TINY_FRESH = "tiny-bpr.fit-partial", "tiny-mf.eval-fresh"
FIT_CHECKS = {"change1_norm_gap", "log_scale_gap", "fold_gap", "bpr_pick_mismatch"}
# The tiny fit cell's ``change1_norm_gap`` limit.  The CPU path adds each
# touch to its row's accumulator on its own, a rounding at the
# accumulator's magnitude each, where the card's kernel adds a row's sum
# once: a sound tiny CPU run reads 1.4e-4 to 2e-4, its bf16 control 2.6e-3
# to 3.2e-3, so the card's limit would fail a sound CPU run.
CPU_CHANGE1 = 1e-3


def tiny_bpr_copy(tmp):
    """``tiny_copy`` with the cells ``tiny-bpr.fit-partial`` (the real
    configuration on tiny Zipf data, a batch of 4,096 and studies of three
    calls, at the real cell's limits but ``CPU_CHANGE1``) and
    ``tiny-mf.eval-fresh`` (500 users a set, three sets) at the real cell's
    limits added."""
    root = tiny_copy(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = core.load_json(core.BENCH_DIR / "configs" / "bpr-adagrad-l2.json")
    data = dict(base["data"], users=TINY_DATA["users"], items=TINY_DATA["items"],
                draws=TINY_DATA["draws"])
    cfg = dict(base, name="tiny-bpr", data=data, fit={"epochs_per_call": 1, "calls_per_study": 3})
    cfg["model"] = dict(base["model"], batch_size=4096)
    (root / "portbench" / "configs" / "tiny-bpr.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-bpr", "source": "https://github.com/lyst/lightfm",
                             "file": "portbench/configs/tiny-bpr.json", "reduced": [],
                             "why": "tiny"})
    mix = dict(core.load_json(core.BENCH_DIR / "traffic" / "eval-fresh.json"), test_users=500,
               test_sets=3, trace_requests=2)
    (root / "portbench" / "traffic" / "eval-fresh-tiny.json").write_text(json.dumps(mix))
    for tiny, config, traffic, real in ((TINY_FIT, "tiny-bpr", "fit-partial-bpr", FIT),
                                        (TINY_FRESH, "tiny-mf", "eval-fresh-tiny", FRESH)):
        bench["workloads"].append({"name": tiny, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "tiny"})
        limits = core.load_json(core.BENCH_DIR / "limits" / f"{real}.json")
        if tiny == TINY_FIT:
            limits["change1_norm_gap"] = CPU_CHANGE1
        (root / "portbench" / "limits" / f"{tiny}.json").write_text(json.dumps(limits))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(tiny)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_bpr_copy(tmp_path_factory.mktemp("bench"))


def _driver_run(root, name, seed=77):
    c = cell(root, name)
    driver = importlib.import_module(f"portbench.drivers.{c.traffic['driver']}")
    return c, driver.Run(c, seed, torch.device("cpu"))


def test_the_cells_are_in_the_benchmark_with_their_metrics():
    fit = core.Cell(FIT)
    assert fit.chips == 1 and fit.traffic["driver"] == "fit_partial_bpr"
    assert set(fit.limits) == FIT_CHECKS and fit.limits["bpr_pick_mismatch"] == 0
    assert {m["name"] for m in fit.metrics("end_to_end")} == {"train_examples_per_s", "setup_s"}
    assert {m["name"] for m in fit.metrics("per_layer")} == {
        "mfu.fit", "launches_per_step.fit", "step_score_ms.fit", "step_update_ms.fit",
        "step_l2_ms.fit", "hybrid_update_roofline.fit", "bpr_sample_ms.fit",
        "bpr_tries_ms.fit"}
    m = fit.config["model"]
    assert (m["loss"], m["learning_schedule"], m["no_components"]) == ("bpr", "adagrad", 32)
    assert m["item_alpha"] == m["user_alpha"] == 1e-5 and m["learning_rate"] == 0.05
    fresh = core.Cell(FRESH)
    assert fresh.chips == 1 and fresh.traffic["driver"] == "eval_fresh"
    assert fresh.traffic["test_sets"] == 4 and fresh.limits == {"ranks_outside_band": 0}
    assert {m["name"] for m in fresh.metrics("end_to_end")} == {
        "served_users_per_s", "request_p95_ms", "setup_s"}
    assert {m["name"] for m in fresh.metrics("per_layer")} == {
        m["name"] for m in core.Cell("warp-mf-d64.eval").metrics("per_layer")}
    for c in (fit, fresh):
        for m in c.metrics("per_layer"):
            assert callable(c.reader(m["name"]).read)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [TINY_FIT, TINY_FRESH])
def test_tiny_line_is_correct(root, name, trace):
    rc, _, line = run_cell(root, name, seed=2**31 + 77, trace=trace)
    assert rc == 0 and line["correct"] is True, line and line["checks"]
    assert set(line["checks"]) == (FIT_CHECKS if name == TINY_FIT else {"ranks_outside_band"})
    if trace:
        # A CPU trace holds no device operation, so no reader finds anything.
        assert line["metrics"] == {}
    elif name == TINY_FIT:
        assert set(line["metrics"]) == {"train_examples_per_s", "setup_s"}
    else:
        assert set(line["metrics"]) == {"served_users_per_s", "request_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", faults_bpr.FAULTS)
def test_a_run_with_a_bpr_fault_under_it_is_not_correct(root, fault):
    with faults_bpr.in_checked_call(fault):
        rc, _, line = run_cell(root, TINY_FIT)
    assert rc == 0 and line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name", [TINY_FIT, TINY_FRESH])
def test_control_fails_the_cells_limits(root, name):
    c, run = _driver_run(root, name)
    run.setup()
    run.window(4.0)
    run.release()
    got, control = run.checks(), run.control()
    assert all(got[k] <= limit for k, limit in c.limits.items()), got
    assert any(control[k] > limit for k, limit in c.limits.items()), control


def test_every_eval_fresh_call_passes_a_matrix_no_earlier_call_passed(root, monkeypatch):
    from lightfm_tpu_torch import LightFM, observability

    _, run = _driver_run(root, TINY_FRESH)
    kept = []  # every test matrix passed, kept alive so that no id is reused
    rank = LightFM.predict_rank

    def watch(self, test, *a, **k):
        assert all(test is not t for t in kept)
        kept.append(test)
        return rank(self, test, *a, **k)

    monkeypatch.setattr(LightFM, "predict_rank", watch)
    run.setup()
    with observability.recording() as rec:
        out = run.window(2.0)
    run.traced()
    calls = 1 + out["attempted"] + 2 * run.tr["trace_requests"]
    assert len(kept) == calls > 4
    # Every call of the window converted its test matrix afresh.
    assert rec.counters.get("rank_prep_misses", 0) == out["attempted"]
    assert not rec.counters.get("rank_prep_hits")
    assert {k for k, _ in run.results} == {0, 1, 2}


def _readings_on_the_card(*args):
    out = subprocess.run([sys.executable, str(core.BENCH_DIR / "readings_bpr.py"), *args],
                         capture_output=True, text=True, timeout=2400, cwd=core.REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    return list(map(json.loads, out.stdout.splitlines()))


@pytest.mark.card
def test_controls_and_faults_at_the_cells_size_on_the_card(card):
    for name in (FIT, FRESH):
        limits = core.Cell(name).limits
        for line in _readings_on_the_card("--workload", name, "--control", "--seeds", "907"):
            assert all(line["program"][k] <= limit for k, limit in limits.items())
            assert any(line["control"][k] > limit for k, limit in limits.items())
    limits = core.Cell(FIT).limits
    for fault in faults_bpr.FAULTS:
        line, = _readings_on_the_card("--workload", FIT, "--fault", fault, "--seeds", "908")
        assert any(line["program"][k] > limit for k, limit in limits.items()), fault
