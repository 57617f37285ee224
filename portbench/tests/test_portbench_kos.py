"""The cells ``warp-kos-adadelta.fit-partial`` and ``warp-mf-d64.recommend``
through a tiny copy on the CPU: their lines are correct, traced and
untraced; the k-OS faults and the bfloat16 control fail the fit cell's
limits, the TF32 control the recommend cell's.  On the card, the controls
and every fault at the cells' own size."""

import importlib
import json
import subprocess
import sys

import pytest
import torch

from portbench import core, faults_kos
from _tiny import TINY_DATA, cell, run_cell, tiny_copy

FIT, REC = "warp-kos-adadelta.fit-partial", "warp-mf-d64.recommend"
TINY_FIT, TINY_REC = "tiny-kos.fit-partial", "tiny-mf.recommend"
FIT_CHECKS = {"change1_norm_gap", "log_scale_gap", "fold_gap", "kos_pick_mismatch"}
REC_CHECKS = {"topk_outside_band", "topk_score_gap"}


def tiny_kos_copy(tmp):
    """``tiny_copy`` with the cells ``tiny-kos.fit-partial`` (the real
    configuration on the tiny data, a batch of 4,096 and studies of three
    calls, at the real cell's limits) and ``tiny-mf.recommend`` (256 users a
    call) added."""
    root = tiny_copy(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = core.load_json(core.BENCH_DIR / "configs" / "warp-kos-adadelta.json")
    cfg = dict(base, name="tiny-kos", data=TINY_DATA,
               fit={"epochs_per_call": 1, "calls_per_study": 3})
    cfg["model"] = dict(base["model"], batch_size=4096)
    (root / "portbench" / "configs" / "tiny-kos.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-kos", "source": "https://github.com/lyst/lightfm",
                             "file": "portbench/configs/tiny-kos.json", "reduced": [],
                             "why": "tiny"})
    mix = dict(core.load_json(core.BENCH_DIR / "traffic" / "recommend.json"),
               users_per_call=256, trace_requests=2)
    (root / "portbench" / "traffic" / "recommend-tiny.json").write_text(json.dumps(mix))
    for tiny, config, traffic, real in ((TINY_FIT, "tiny-kos", "fit-partial", FIT),
                                        (TINY_REC, "tiny-mf", "recommend-tiny", REC)):
        bench["workloads"].append({"name": tiny, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "tiny"})
        (root / "portbench" / "limits" / f"{tiny}.json").write_text(
            (core.BENCH_DIR / "limits" / f"{real}.json").read_text())
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(tiny)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_kos_copy(tmp_path_factory.mktemp("bench"))


def _driver_run(root, name, seed=77):
    c = cell(root, name)
    driver = importlib.import_module(f"portbench.drivers.{c.traffic['driver']}")
    return c, driver.Run(c, seed, torch.device("cpu"))


def test_the_cells_are_in_the_benchmark_with_their_metrics():
    fit = core.Cell(FIT)
    assert fit.chips == 1 and fit.traffic["driver"] == "fit_partial"
    assert set(fit.limits) == FIT_CHECKS
    assert {m["name"] for m in fit.metrics("end_to_end")} == {"train_examples_per_s", "setup_s"}
    assert {m["name"] for m in fit.metrics("per_layer")} == {
        "mfu.fit", "launches_per_step.fit", "step_score_ms.fit", "step_update_ms.fit",
        "step_l2_ms.fit", "kos_pick_ms.fit", "adadelta_update_roofline.fit"}
    m = fit.config["model"]
    assert (m["loss"], m["learning_schedule"], m["no_components"]) == ("warp-kos", "adadelta", 30)
    assert m["item_alpha"] == m["user_alpha"] == 1e-3
    rec = core.Cell(REC)
    assert rec.chips == 1 and rec.traffic["driver"] == "recommend"
    assert set(rec.limits) == REC_CHECKS and rec.limits["topk_outside_band"] == 0
    assert {m["name"] for m in rec.metrics("end_to_end")} == {
        "served_users_per_s", "request_p95_ms", "setup_s"}
    assert {m["name"] for m in rec.metrics("per_layer")} == {"mfu.eval", "device_idle.eval"}
    for c in (fit, rec):
        for m in c.metrics("per_layer"):
            assert callable(c.reader(m["name"]).read)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [TINY_FIT, TINY_REC])
def test_tiny_line_is_correct(root, name, trace):
    rc, _, line = run_cell(root, name, seed=2**31 + 77, trace=trace)
    assert rc == 0 and line["correct"] is True, line and line["checks"]
    assert set(line["checks"]) == (FIT_CHECKS if name == TINY_FIT else REC_CHECKS)
    if trace:
        # A CPU trace holds no device operation, so no reader finds anything.
        assert line["metrics"] == {}
    elif name == TINY_FIT:
        assert set(line["metrics"]) == {"train_examples_per_s", "setup_s"}
    else:
        assert set(line["metrics"]) == {"served_users_per_s", "request_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", faults_kos.FAULTS)
def test_a_run_with_a_kos_fault_under_it_is_not_correct(root, fault):
    with faults_kos.in_checked_call(fault):
        rc, _, line = run_cell(root, TINY_FIT)
    assert rc == 0 and line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name", [TINY_FIT, TINY_REC])
def test_control_fails_the_cells_limits(root, name):
    c, run = _driver_run(root, name)
    run.setup()
    run.window(6.0)
    run.release()
    got, control = run.checks(), run.control()
    assert all(got[k] <= limit for k, limit in c.limits.items()), got
    assert any(control[k] > limit for k, limit in c.limits.items()), control


def test_the_fit_cell_starts_a_study_afresh_every_so_many_calls(root):
    _, run = _driver_run(root, TINY_FIT)
    run.setup()
    for _ in range(5):
        run._fit()
    assert run.calls == ["fit", "fit_partial", "fit_partial"] * 2


def _readings_on_the_card(*args):
    out = subprocess.run([sys.executable, str(core.BENCH_DIR / "readings_kos.py"), *args],
                         capture_output=True, text=True, timeout=2400, cwd=core.REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    return list(map(json.loads, out.stdout.splitlines()))


@pytest.mark.card
def test_controls_and_faults_at_the_cells_size_on_the_card(card):
    for name in (FIT, REC):
        limits = core.Cell(name).limits
        for line in _readings_on_the_card("--workload", name, "--control", "--seeds", "905"):
            assert all(line["program"][k] <= limit for k, limit in limits.items())
            assert any(line["control"][k] > limit for k, limit in limits.items())
    limits = core.Cell(FIT).limits
    for fault in faults_kos.FAULTS:
        line, = _readings_on_the_card("--workload", FIT, "--fault", fault, "--seeds", "906")
        assert any(line["program"][k] > limit for k, limit in limits.items()), fault
