"""The readers of the program's host spans: ``recommend``'s parts in the
recommend cell, and the step's host time and update launches in the fit
cells.  Each is held against the kept spans of a tiny traced run on the
CPU with synthetic device operations put inside them; each reads nothing
from a window without device operations or from a program that marks none
of its spans, and raises where some traced calls or steps lost a span."""

import importlib
import statistics

import pytest
import torch

from portbench import core, host_spans
from _tiny import cell
from test_portbench_bpr import tiny_bpr_copy
from test_portbench_kos import TINY_FIT, TINY_REC, tiny_kos_copy

REC = "warp-mf-d64.recommend"
FITS = ("warp-mf-d64.fit", "warp-hybrid-l2.fit", "warp-kos-adadelta.fit-partial",
        "bpr-adagrad-l2.fit-partial")
REC_READERS = ("recommend_inputs_ms.eval", "recommend_exclude_ms.eval", "recommend_topk_ms.eval",
               "recommend_result_ms.eval", "recommend_idle_unnamed_ms.eval")
FIT_READERS = ("step_host_ms.fit", "update_host_ms.fit", "update_launches.fit")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A tiny copy of the benchmark for each tiny cell, made when first asked."""
    made = {}

    def root(name):
        copy = tiny_bpr_copy if name.startswith("tiny-bpr") else tiny_kos_copy
        if copy not in made:
            made[copy] = copy(tmp_path_factory.mktemp("bench"))
        return made[copy]

    return root


def _traced(root, name, seed=2**31 + 5):
    c = cell(root, name)
    driver = importlib.import_module(f"portbench.drivers.{c.traffic['driver']}")
    run = driver.Run(c, seed, torch.device("cpu"))
    run.setup()
    ctx = run.traced()
    run.release()
    return c, ctx


def _put_inside(tr, spans, per_span=1, ns=10_000):
    """``per_span`` synthetic device operations launched inside each span,
    each running ``ns`` from its launch."""
    k = 10_000 + len(tr.runtime)
    for s in spans:
        for n in range(per_span):
            at = s.start_ns + (n + 1) * (s.end_ns - s.start_ns) // (per_span + 1)
            tr.gpu.append((at, at + ns, "synthetic", k, "kernel"))
            tr.runtime.append((at, k))
            k += 1
    tr.gpu.sort()
    tr.runtime.sort()
    tr._runtime_starts = [r[0] for r in tr.runtime]


def _read(c, names, ctx):
    return {n: c.reader(n).read(ctx) for n in names}


def _kept(monkeypatch, keep):
    """The program's kept spans seen through ``keep(record)``."""
    from lightfm_tpu_torch import observability

    real = observability.kept_between

    def kept(t0, t1):
        rec = real(t0, t1)
        keep(rec)
        return rec

    monkeypatch.setattr(observability, "kept_between", kept)


def _ms(ns_values):
    return statistics.median(ns_values) * 1e-6


def test_the_cells_list_the_new_readers():
    bench = core.load_json(core.REPO / "BENCHMARK.json")
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in REC_READERS:
        assert listed[name]["workloads"] == [REC] and listed[name]["layer"] == "serving"
    for name in FIT_READERS:
        assert listed[name]["workloads"] == list(FITS)
    for name in (REC,) + FITS:
        c = core.Cell(name)
        got = {m["name"] for m in c.metrics("per_layer")}
        assert set(REC_READERS if name == REC else FIT_READERS) <= got
        for m in REC_READERS if name == REC else FIT_READERS:
            assert callable(c.reader(m).read)


def test_recommend_readers_read_the_parts_of_each_traced_request(roots, monkeypatch):
    from lightfm_tpu_torch import observability

    c, ctx = _traced(roots(TINY_REC), TINY_REC)
    tr = ctx["trace"]
    assert _read(c, REC_READERS, ctx) == dict.fromkeys(REC_READERS)  # no device operation
    rec = observability.kept_between(tr.t0, tr.t1)
    calls = rec.named("recommend")
    assert len(calls) == ctx["requests"]
    _put_inside(tr, rec.named("recommend.topk"), per_span=2, ns=1_000_000)
    got = _read(c, REC_READERS, ctx)
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got

    def part_ms(name):
        return _ms(sum(s.end_ns - s.start_ns for s in rec.named(name) if s.call == r.call)
                   for r in calls)

    for name in ("inputs", "exclude", "result"):
        assert got[f"recommend_{name}_ms.eval"] == part_ms(f"recommend.{name}")
    assert got["recommend_topk_ms.eval"] == pytest.approx(2.0)
    # The parts follow one another, so the idle time no part names lies in
    # the call's own gaps between them.
    gaps = _ms((r.end_ns - r.start_ns) - sum(
        s.end_ns - s.start_ns for s in rec.spans
        if s.parent is not None and rec.spans[s.parent] == r) for r in calls)
    assert got["recommend_idle_unnamed_ms.eval"] <= gaps + 1e-9
    assert got["recommend_idle_unnamed_ms.eval"] < part_ms("recommend.inputs")

    with monkeypatch.context() as m:
        # A program whose recommend marks no parts, as the parent's.
        _kept(m, lambda r: setattr(r, "spans", [
            s for s in r.spans if not s.name.startswith("recommend.")]))
        assert _read(c, REC_READERS, ctx) == dict.fromkeys(REC_READERS)
    with monkeypatch.context() as m:
        # Calls without an exclusion list: that part alone is absent.
        _kept(m, lambda r: setattr(r, "spans", [
            s._replace(name="other") if s.name == "recommend.exclude" else s
            for s in r.spans]))
        without = _read(c, REC_READERS, ctx)
        assert without["recommend_exclude_ms.eval"] is None
        assert None not in [v for k, v in without.items() if k != "recommend_exclude_ms.eval"]
    with monkeypatch.context() as m:
        # One traced call lost its parts: every reader of them raises.
        last = calls[-1].call
        _kept(m, lambda r: setattr(r, "spans", [
            s for s in r.spans if not (s.name.startswith("recommend.") and s.call == last)]))
        for n in REC_READERS:
            with pytest.raises(RuntimeError, match="recommend"):
                c.reader(n).read(ctx)
    monkeypatch.delattr(observability, "kept_between")
    assert _read(c, REC_READERS, ctx) == dict.fromkeys(REC_READERS)


# name: (whole step spans in the window, step.l2 spans a step)
FIT_CASES = {"tiny-mf.fit": (0, 0), TINY_FIT: (-1, 2), "tiny-bpr.fit-partial": (-1, 2)}


@pytest.mark.parametrize("name", list(FIT_CASES))
def test_fit_readers_read_the_whole_steps_and_the_update_spans(roots, monkeypatch, name):
    """The fast path's driver starts the profiler before its first traced
    step, the generic drivers inside it: their windows hold every traced
    step's ``step`` span or all but the first's.  The readers divide by
    what they find."""
    from lightfm_tpu_torch import observability

    c, ctx = _traced(roots(name), name)
    tr = ctx["trace"]
    assert _read(c, FIT_READERS, ctx) == dict.fromkeys(FIT_READERS)  # no device operation
    rec = observability.kept_between(tr.t0, tr.t1)
    short, l2_per_step = FIT_CASES[name]
    steps, updates, l2 = rec.named("step"), rec.named("step.update"), rec.named("step.l2")
    n = ctx["steps"]
    assert (len(steps), len(updates), len(l2)) == (n + short, n, l2_per_step * n)
    _put_inside(tr, updates, per_span=3)
    _put_inside(tr, l2, per_span=1)
    _put_inside(tr, rec.named("step.score"), per_span=2)
    got = _read(c, FIT_READERS, ctx)
    assert got["step_host_ms.fit"] == pytest.approx(
        sum(s.end_ns - s.start_ns for s in steps) * 1e-6 / len(steps))
    assert got["update_host_ms.fit"] == pytest.approx(
        sum(s.end_ns - s.start_ns for s in updates + l2) * 1e-6 / n)
    assert got["update_launches.fit"] == 3 + l2_per_step
    assert host_spans.launched_in(tr, rec.named("step.score")) == 2 * n

    with monkeypatch.context() as m:
        # Steps lost from the window beyond the one the drivers lose.
        _kept(m, lambda r: setattr(r, "spans", [
            s for s in r.spans if s not in r.named("step")[:2]]))
        with pytest.raises(RuntimeError, match="'step'"):
            c.reader("step_host_ms.fit").read(ctx)
    with monkeypatch.context() as m:
        _kept(m, lambda r: setattr(r, "spans", [
            s for s in r.spans if s is not r.named("step.update")[-1]]))
        for n_ in ("update_host_ms.fit", "update_launches.fit"):
            with pytest.raises(RuntimeError, match="step.update"):
                c.reader(n_).read(ctx)
    if l2_per_step:
        with monkeypatch.context() as m:
            _kept(m, lambda r: setattr(r, "spans", [
                s for s in r.spans if s is not r.named("step.l2")[0]]))
            with pytest.raises(RuntimeError, match="step.l2"):
                c.reader("update_launches.fit").read(ctx)
    with monkeypatch.context() as m:
        # A program that marks no step and no update span.
        _kept(m, lambda r: setattr(r, "spans", [
            s for s in r.spans if s.name not in ("step", "step.update", "step.l2")]))
        assert _read(c, FIT_READERS, ctx) == dict.fromkeys(FIT_READERS)
    monkeypatch.delattr(observability, "kept_between")
    assert _read(c, FIT_READERS, ctx) == dict.fromkeys(FIT_READERS)
