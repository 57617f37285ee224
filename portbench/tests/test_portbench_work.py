"""The operation and byte counts equal hand counts at tiny shapes, and the
trace reader's interval arithmetic."""

import pytest

from portbench import traced, work


def test_warp_example_flops_by_hand():
    # D = 2, K = 1: 2 scores of 3 terms (12), gradient rows (12), three
    # touched rows of 3 entries at 6 FLOPs (54).
    assert work.warp_example_flops(2, 1) == 12 + 12 + 54


def test_rank_call_flops_by_hand():
    assert work.rank_call_flops(U=2, I=3, D=4, T=5) == 2 * 3 * 10 + 2 * 3 * 5


def test_kernel_bounds_by_hand():
    hbm, peak = work.PEAK_HBM_BYTES_PER_S, work.PEAK_FP32_FLOPS
    assert work.k1_bound_s(10, 8, 3) == pytest.approx((4 * 10 * 9 + 16 * 8 * 3) / hbm)
    # Compute-bound at these shapes: 2 * 100 * 1000 * 73 + 100 * 1000 * 10 operations.
    ops = 2 * 100 * 1000 * 73 + 100 * 1000 * 10
    assert work.k2_bound_s(100, 1000, 73, 10) == pytest.approx(ops / peak)
    assert work.share_pct(1.0, 4.0) == 25.0 and work.share_pct(1.0, 0.0) is None


def _trace(gpu, spans, runtime, t0=0, t1=100):
    tr = traced.DeviceTrace.__new__(traced.DeviceTrace)
    tr.t0, tr.t1 = t0, t1
    tr.gpu = sorted(gpu)
    tr.spans = sorted(spans)
    tr.runtime = sorted(runtime)
    tr._runtime_starts = [r[0] for r in tr.runtime]
    tr._busy = traced._union([(max(s, t0), min(e, t1)) for s, e, *_ in tr.gpu])
    return tr


def test_trace_busy_idle_and_launch_attribution():
    gpu = [(10, 30, "a", 1, "kernel"), (20, 40, "b", 2, "kernel"), (60, 70, "a", 3, "memset")]
    spans = [(0, 50, "step"), (5, 8, "k1"), (52, 90, "check")]
    runtime = [(6, 1), (9, 2), (55, 3)]
    tr = _trace(gpu, spans, runtime)
    assert tr.busy_s == pytest.approx(40e-9) and tr.window_s == pytest.approx(100e-9)
    assert tr.kernel_count() == 2
    assert tr.device_s_of_span("k1") == pytest.approx(20e-9)
    assert tr.device_s_launched_in(0, 50) == pytest.approx(40e-9)
    assert tr.top_ops(1) == [["a", pytest.approx(30e-9)]]
    idle = dict(tr.idle_by_span())
    # Gaps: 0-10 (step, k1 from 5 to 8), 40-60 (step to 50, none to 52,
    # check after), 70-100 (check to 90, then none).
    assert idle == {"step": pytest.approx(17e-9), "k1": pytest.approx(3e-9),
                    "none": pytest.approx(12e-9), "check": pytest.approx(28e-9)}
