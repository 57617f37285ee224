"""The control (the reference in the next precision below the
configuration's, put in the program's place) and every fault a cell can
have come out as not correct; on the card, the control at the cell's own
size."""

import importlib
import json
import subprocess
import sys

import pytest
import torch

from portbench import core, faults
from _tiny import cell, run_cell, tiny_copy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


def _driver_run(root, name, seed=77):
    c = cell(root, name)
    driver = importlib.import_module(f"portbench.drivers.{c.traffic['driver']}")
    return c, driver.Run(c, seed, torch.device("cpu"))


@pytest.mark.parametrize("name", ["tiny-mf.fit", "tiny-mf.eval"])
def test_control_fails_the_cells_limits(root, name):
    c, run = _driver_run(root, name)
    run.setup()
    run.window(4.0)
    run.release()
    got, control = run.checks(), run.control()
    assert all(got[k] <= limit for k, limit in c.limits.items())
    assert any(control[k] > limit for k, limit in c.limits.items())


@pytest.mark.parametrize("name,fault", [("tiny-mf.fit", f) for f in faults.FIT_FAULTS]
                         + [("tiny-mf.eval", f) for f in faults.EVAL_FAULTS])
def test_a_run_with_a_fault_under_it_is_not_correct(root, name, fault):
    with faults.planted(fault):
        rc, _, line = run_cell(root, name)
    assert rc == 0 and line["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("name", ["warp-mf-d64.fit", "warp-mf-d64.eval"])
def test_control_at_the_cells_size_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, str(core.BENCH_DIR / "readings.py"), "--workload", name, "--control",
         "--seeds", "901", "902", "903"],
        capture_output=True, text=True, timeout=1800, cwd=core.REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    limits = core.Cell(name).limits
    for line in map(json.loads, out.stdout.splitlines()):
        assert all(line["program"][k] <= limit for k, limit in limits.items())
        assert any(line["control"][k] > limit for k, limit in limits.items())


def test_the_checked_fit_follows_the_window_and_the_reference_replays_the_fits_before(root):
    c, run = _driver_run(root, "tiny-mf.fit")
    run.setup()
    out = run.window(4.0)
    run.release()
    assert run.fits_before == 1 + out["attempted"]
    assert all(v <= c.limits[k] for k, v in run.checks().items() if k in c.limits)
    # The reference started at the model's first fit instead: another state.
    run._refs, run.fits_before = {}, 0
    assert any(v > 10 * c.limits[k] for k, v in run.checks().items() if k in c.limits)
