"""The last line of a run holds exactly the contract's keys, with the
compared numbers last; the tiny cells agree with the reference."""

import pytest

from _tiny import run_cell, tiny_copy

TOP = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ["tiny-mf.fit", "tiny-mf.eval"])
def test_untraced_line_has_the_contract_keys_and_agrees_with_the_reference(root, name):
    rc, lines, line = run_cell(root, name, trace=0)
    assert rc == 0 and list(line) == TOP
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    want = {"train_examples_per_s"} if name.endswith(".fit") else {
        "served_users_per_s", "request_p95_ms"}
    assert set(line["metrics"]) == want | {"setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("name", ["tiny-mf.fit", "tiny-mf.eval"])
def test_traced_line_adds_the_window_and_breakdown(root, name):
    rc, _, line = run_cell(root, name, trace=1)
    assert rc == 0 and list(line) == TOP[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"]) and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # A CPU trace holds no device operation, so no reader finds anything.
    assert line["metrics"] == {} and line["device"]["busy_s"] == 0
    assert line["correct"] is True
