"""The port's observability: ``trace`` writes a ``torch.profiler`` trace of
a small CPU fit as TensorBoard's ``*.pt.trace.json``, and ``device=None``
means CUDA, so it raises on a machine without a GPU.  Spans cost one test
and read no clock while nothing observes them; under ``recording()`` a fit
and a ``predict_rank`` keep their layers' spans, nested, with their call's
id, on the profiler's clock, and a ``recommend`` its parts; the counters
count what they name."""

import json
import zlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from lightfm_tpu_torch import LightFM, observability, sparse
from lightfm_tpu_torch.ops import ranking
from lightfm_tpu_torch.parallel import mesh as pmesh

# The spans of a fast-path WARP fit and a CPU predict_rank (the flat tier:
# the kernels' spans need a CUDA device).
FIT_SPANS = {"fit", "fit.stage", "fit.finite_check", "epoch.draws", "epoch.shuffle", "step",
             "step.score", "step.grads", "step.update", "kernel.k1"}
RANK_SPANS = {"predict_rank", "predict_rank.intersections", "predict_rank.inputs",
              "fingerprint", "rank.prep", "rank.tier", "rank.readback", "rank.scatter",
              "predict_rank.result"}


def _small_interactions():
    rng = np.random.RandomState(0)
    rows = np.repeat(np.arange(40), 5)
    cols = rng.randint(0, 30, rows.size)
    return sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(40, 30))


@pytest.fixture(scope="module")
def fast_data():
    """A WARP problem whose item table (8,000 x 72) is large enough for
    the fast path, split into train and test by interaction."""
    rng = np.random.RandomState(3)
    rows = np.repeat(np.arange(600), 12)
    cols = rng.randint(0, 8000, rows.size)
    m = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(600, 8000)).tocsr()
    m.sum_duplicates()
    m.data[:] = 1.0
    coo = m.tocoo()
    test = np.arange(coo.nnz) % 4 == 0

    def part(keep):
        return sp.csr_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])), shape=m.shape)

    return part(~test), part(test)


def _fast_model():
    return LightFM(loss="warp", no_components=64, random_state=5, device="cpu",
                   fast_path="on", batch_size=2048)


def _descendants(spans, root):
    out, frontier = [], {root}
    for i, s in enumerate(spans):
        if s.parent in frontier:
            frontier.add(i)
            out.append(i)
    return out


def test_cpu_trace_of_a_fit_is_written(tmp_path):
    model = LightFM(no_components=4, random_state=2, device="cpu")
    with observability.trace(str(tmp_path), device="cpu") as prof:
        model.fit(_small_interactions(), epochs=1)
    assert isinstance(prof, torch.profiler.profile)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert not any(e.get("cat") == "kernel" for e in events)  # no CUDA activity asked for
    assert model.fit_stats_.wall_s is not None


def test_cpu_trace_holds_the_program_spans(tmp_path):
    model = LightFM(no_components=4, random_state=2, device="cpu")
    train = _small_interactions()
    with observability.trace(str(tmp_path), device="cpu"):
        model.fit(train, epochs=1)
        model.predict_rank(train)
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
    want = {"fit", "fit.stage", "fit.finite_check", "epoch.draws", "epoch.shuffle", "step",
            "predict_rank", "rank.prep", "rank.tier", "rank.readback", "predict_rank.result"}
    assert {observability.PREFIX + n for n in want} <= names


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default trace would record it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with observability.trace(str(tmp_path)):
            pass
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with observability.trace(str(tmp_path), device="cuda"):
            pass
    assert list(tmp_path.iterdir()) == []


def _count_span_costs(monkeypatch) -> dict:
    """Count the profiler ranges entered (the program's and
    ``record_function``) and the span clock's reads from now on."""
    calls = {"range": 0, "record_function": 0, "clock": 0}

    def counting(key, fn):
        def inner(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return inner

    monkeypatch.setattr(observability, "_profiler_range",
                        counting("range", observability._profiler_range))
    monkeypatch.setattr(observability, "_clock", counting("clock", observability._clock))
    for owner in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(owner, "record_function",
                            counting("record_function", owner.record_function))
    return calls


def test_spans_off_open_no_profiler_range_and_read_no_clock(monkeypatch, fast_data):
    """With no profiler and no recording, a fit and a predict_rank enter no
    profiler range (neither the program's nor ``record_function``) and
    read no clock for a span."""
    calls = _count_span_costs(monkeypatch)
    train, test = fast_data
    model = _fast_model().fit(train, epochs=1)
    assert model._staged_fast
    model.predict_rank(test, train_interactions=train)
    assert calls == {"range": 0, "record_function": 0, "clock": 0}
    assert not observability._profiler_enabled()


def test_recording_keeps_the_layer_spans_nested_with_their_call(monkeypatch, fast_data):
    train, test = fast_data
    hashed = []

    class Spy:
        @staticmethod
        def crc32(raw):
            hashed.append(raw.nbytes)
            return zlib.crc32(raw)

    monkeypatch.setattr(sparse, "zlib", Spy)
    model = _fast_model()
    with observability.recording() as rec:
        model.fit(train, epochs=2)
        first = model.predict_rank(test, train_interactions=train)
        again = model.predict_rank(test, train_interactions=train)
    assert model._staged_fast
    np.testing.assert_array_equal(first.data, again.data)
    names = {s.name for s in rec.spans}
    assert FIT_SPANS | RANK_SPANS <= names
    n_batches = model._staged_train_data.packed.shape[1] // model._staged_batch_size
    assert len(rec.named("step")) == len(rec.named("step.score")) == 2 * n_batches

    roots = [i for i, s in enumerate(rec.spans) if s.parent is None]
    assert [rec.spans[i].name for i in roots] == ["fit", "predict_rank", "predict_rank"]
    calls = [rec.spans[i].call for i in roots]
    assert None not in calls and len(set(calls)) == 3
    for i in roots:
        inner = _descendants(rec.spans, i)
        assert inner and {rec.spans[j].call for j in inner} == {rec.spans[i].call}
    assert len(roots) + sum(len(_descendants(rec.spans, i)) for i in roots) == len(rec.spans)
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    parent = {s.name: rec.spans[s.parent].name for s in rec.spans if s.parent is not None}
    assert parent["step.score"] == parent["step.grads"] == parent["step.update"] == "step"
    assert parent["kernel.k1"] == "step.update" and parent["rank.tier"] == "predict_rank"
    assert parent["predict_rank.intersections"] == "predict_rank"

    # Each call hashes test and train once: data, indices and indptr.
    per_call = sum(a.nbytes for m in (test, train) for a in (m.data, m.indices, m.indptr))
    assert rec.counters["fingerprint_bytes"] == sum(hashed) == 2 * per_call
    assert rec.counters["rank_prep_misses"] == 1 and rec.counters["rank_prep_hits"] == 1
    assert rec.counters["intersection_misses"] == 1 and rec.counters["intersection_hits"] == 1
    assert len(rec.named("fingerprint")) == len(hashed) // 3 == 4
    for i, s in enumerate(rec.spans):
        assert 0 <= rec.self_ns(i) <= s.end_ns - s.start_ns


RECOMMEND_PARTS = ("recommend.inputs", "recommend.exclude", "recommend.catalog",
                   "recommend.topk", "recommend.result")


@pytest.fixture(scope="module")
def small_model():
    return LightFM(no_components=4, random_state=2, device="cpu").fit(_small_interactions(),
                                                                      epochs=1)


@pytest.mark.parametrize("mode", ["auto", "compressed"])
@pytest.mark.parametrize("excluded", [True, False], ids=["train", "no-train"])
def test_recording_splits_recommend_into_its_parts(small_model, mode, excluded):
    """A recorded ``recommend`` is one span whose parts follow one another
    inside it, each its child with its call id: the inputs, the exclusion
    list (only with ``train_interactions``), the catalog, the top-k of the
    mode that runs and the result.  The answer is the unrecorded call's."""
    train = _small_interactions() if excluded else None
    users = np.array([3, 0, 17, 39])
    with observability.recording() as rec:
        scores, ids = small_model.recommend(users, k=6, train_interactions=train, mode=mode)
    roots = [i for i, s in enumerate(rec.spans) if s.parent is None]
    assert [rec.spans[i].name for i in roots] == ["recommend"]
    top = rec.spans[roots[0]]
    assert top.call is not None and {s.call for s in rec.spans} == {top.call}
    parts = [s for s in rec.spans if s.parent == roots[0]]
    assert [s.name for s in parts] == [
        p for p in RECOMMEND_PARTS if excluded or p != "recommend.exclude"]
    assert top.start_ns <= parts[0].start_ns and parts[-1].end_ns <= top.end_ns
    for s, after in zip(parts, parts[1:]):
        assert s.start_ns <= s.end_ns <= after.start_ns
    want_scores, want_ids = small_model.recommend(users, k=6, train_interactions=train, mode=mode)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(scores, want_scores)


def test_recommend_spans_off_open_no_profiler_range_and_read_no_clock(monkeypatch, small_model):
    """With no profiler and no recording, ``recommend`` in either mode, with
    and without an exclusion list, enters no profiler range and reads no
    clock for its spans."""
    calls = _count_span_costs(monkeypatch)
    train = _small_interactions()
    for mode in ("auto", "compressed"):
        for excluded in (train, None):
            small_model.recommend(np.arange(5), k=3, train_interactions=excluded, mode=mode)
    assert calls == {"range": 0, "record_function": 0, "clock": 0}


def test_kept_spans_are_on_the_profilers_clock():
    """The in-memory start of a span agrees with its start in the
    profiler's trace within 1 ms (another clock would be off by years);
    the range is function-scoped, not the user scope that makes device
    annotations."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("user.scope"):
            pass
        with observability.span("warm"):
            torch.ones(4).sum()
        with observability.recording() as rec:
            for k in range(5):
                with observability.span(f"clock.{k}"):
                    torch.ones(8).sum()
    kineto = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for s in rec.spans:
        e = kineto[observability.PREFIX + s.name]
        assert abs(e.start_ns() - s.start_ns) < 1_000_000
        assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 1_000_000
        assert e.scope() != kineto["user.scope"].scope()
    kept = observability.kept_between(rec.spans[0].start_ns, rec.spans[-1].end_ns)
    assert [s.name for s in kept.spans] == [s.name for s in rec.spans]


def test_counters_and_device_counters():
    before = observability.counters()
    observability.count("test.counter", 3)
    with observability.recording() as rec:
        observability.count("test.counter")
        observability.count("test.counter", 2)
    after = observability.counters()
    assert after["test.counter"] - before.get("test.counter", 0) == 6
    assert rec.counters == {"test.counter": 3}
    after["test.counter"] = -1
    assert observability.counters()["test.counter"] != -1  # a copy

    base = observability.device_counter("test.device")
    observability.count_on_device("test.device", torch.tensor(4))
    observability.count_on_device("test.device", (torch.arange(5) > 1).sum())
    assert observability.device_counter("test.device") - base == 7


def test_rank_clamp_counter_stays_on_the_device(monkeypatch):
    """``_ranks_fused`` counts clamped ranks without reading a value back
    to the host; the count is read only when asked."""
    rng = np.random.RandomState(0)
    U, I, T, P, W = 16, 300, 4, 6, 9
    state = ranking.ModelState(
        torch.from_numpy(rng.randn(I, W).astype(np.float32)), None, None,
        torch.from_numpy(rng.randn(U, W).astype(np.float32)), None, None, None, None)
    user_ids = torch.arange(U, dtype=torch.int32)
    test_idx = torch.from_numpy(rng.randint(0, I, (U, T)).astype(np.int32))
    train_idx = torch.from_numpy(rng.randint(0, I, (U, P)).astype(np.int32))
    test_valid = torch.ones((U, T), dtype=torch.bool)

    def no_read(*a, **k):
        raise AssertionError("the clamp counter read a value back to the host")

    base = observability.device_counter(ranking.CLAMPED)
    with monkeypatch.context() as m:
        for name in ("item", "__int__", "__index__", "__bool__", "tolist"):
            m.setattr(torch.Tensor, name, no_read)
        ranks = ranking._ranks_fused(state, sparse.identity_rows(U), sparse.identity_rows(I),
                                     user_ids, test_idx, test_valid, train_idx, n_items=I,
                                     item_block=128)
    assert ranks.shape == (U, T)
    assert observability.device_counter(ranking.CLAMPED) == base


def test_device_counters_survive_inference_mode(monkeypatch, fast_data):
    """A device counter first made under ``torch.inference_mode()``, as a
    serving loop's first ``predict_rank`` may make it, still counts outside
    it, and the other way round."""
    monkeypatch.setattr(observability, "_device_counts", {})
    with torch.inference_mode():
        observability.count_on_device("test.device", torch.tensor(2))
    observability.count_on_device("test.device", torch.tensor(3))
    with torch.inference_mode():
        observability.count_on_device("test.device", torch.tensor(4))
    observability.count_on_device("test.device", torch.tensor(5))
    assert observability.device_counter("test.device") == 14

    # predict_rank through the fused tier (on the CPU, its plain versions).
    monkeypatch.setattr(ranking, "_fused_tier", lambda T, device_type: T <= ranking.COUNT_T_LIMIT)
    train, test = fast_data
    model = LightFM(loss="warp", no_components=8, random_state=5, device="cpu").fit(train)
    with torch.inference_mode():
        first = model.predict_rank(test, train_interactions=train)
    again = model.predict_rank(test, train_interactions=train)
    np.testing.assert_array_equal(first.data, again.data)
    assert observability.device_counter(ranking.CLAMPED) == 0
    assert [k for k, _ in observability._device_counts] == ["test.device", ranking.CLAMPED]


def test_collectives_are_spans_beside_mesh_stats():
    mesh = pmesh.Mesh(1, 1, 0, torch.device("cpu"))
    block = torch.zeros(4, 8, dtype=torch.uint8)
    with observability.recording() as rec:
        out = pmesh._collective(mesh, block, lambda b: b + 1)
    assert torch.equal(out, block + 1)
    assert [s.name for s in rec.spans] == ["mesh.collective"]
    assert mesh.stats["calls"] == 1 and mesh.stats["bytes"] == 32


def test_the_log_is_bounded_but_a_recording_keeps_its_body(monkeypatch):
    monkeypatch.setattr(observability, "LOG_LIMIT", 64)
    with observability.recording() as rec:
        for _ in range(300):
            with observability.span("bounded"):
                pass
    assert len(rec.named("bounded")) == 300
    assert len(observability._log) <= 64
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(300):
            with observability.span("bounded"):
                pass
    assert len(observability._log) <= 64


def _tagged_problem():
    """A WARP problem with items described by 1-5 of 40 tags (padded to 8)."""
    rng = np.random.RandomState(4)
    inter = sp.coo_matrix((np.ones(1200, np.float32),
                           (rng.randint(0, 150, 1200), rng.randint(0, 90, 1200))),
                          shape=(150, 90))
    inter.sum_duplicates()
    inter.data[:] = 1.0
    n_tags = rng.randint(1, 6, 90)
    rows = np.repeat(np.arange(90), n_tags)
    cols = np.concatenate([rng.choice(40, k, replace=False) for k in n_tags])
    tags = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(90, 40))
    return inter, tags


@pytest.mark.parametrize("alpha", [0.0, 1e-6])
def test_generic_step_marks_its_parts_and_counts_its_shapes(alpha):
    inter, tags = _tagged_problem()
    B, epochs = 256, 2
    model = LightFM(loss="warp", no_components=6, item_alpha=alpha, batch_size=B,
                    random_state=3, device="cpu")
    with observability.recording() as rec:
        model.fit(inter, item_features=tags, epochs=epochs)
    assert model._staged_fast is False
    steps = epochs * model._staged_train_data.packed.shape[1] // B
    P = model._staged_train_data.item_feats.max_nnz
    assert P == 8
    parts = ("step", "step.score", "step.grads", "step.update")
    assert [len(rec.named(p)) for p in parts] == [steps] * 4
    # With L2 two a step: the scale bump that ends the step, the guard after it.
    assert len(rec.named("step.l2")) == (2 * steps if alpha else 0)
    assert len(rec.named("epoch.l2_fold")) == (epochs if alpha else 0)
    parent = {s.name: rec.spans[s.parent].name for s in rec.spans if s.parent is not None}
    for part in parts[1:] + (("step.l2",) if alpha else ()):
        assert parent[part] == "step"
    if alpha:
        assert parent["epoch.l2_fold"] == "fit"
    assert rec.counters["update_touches.item"] == steps * 2 * B * P
    assert rec.counters["update_touches.user"] == steps * B


def test_fast_path_span_counts_are_unchanged(fast_data):
    train, _ = fast_data
    model = _fast_model()
    with observability.recording() as rec:
        model.fit(train, epochs=2)
    assert model._staged_fast
    steps = 2 * model._staged_train_data.packed.shape[1] // model._staged_batch_size
    counts = {n: len(rec.named(n)) for n in ("step", "step.score", "step.grads", "step.update",
                                               "kernel.k1", "step.l2", "epoch.l2_fold")}
    assert counts == {"step": steps, "step.score": steps, "step.grads": steps,
                      "step.update": steps, "kernel.k1": 2 * steps, "step.l2": 0,
                      "epoch.l2_fold": 0}
    assert not {"update_touches.item", "update_touches.user"} & set(rec.counters)
