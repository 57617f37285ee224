"""K3 (lightfm_tpu_torch.ops.grad_sums) vs the JAX package, on the CPU.

The port's wrapper takes its plain version for CPU tensors; it is held
against ``sorted_grad_sums_pallas`` run in Pallas interpret mode (as
``tests/test_pallas.py:327-381`` runs it) at ``"highest"``, and against a
numpy float64 model of the bf16 operand rounding at ``"default"``.

Tolerance ("f32 summation order"): per element
``|got - want| <= (n_r + 1) * 2^-23 * sum|terms|``, where ``n_r`` is the
row's touch count: the worst case of recursive fp32 summation of n_r terms.
Untouched rows and ignored touches are compared exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightfm_tpu.ops.pallas_update import sorted_grad_sums_pallas

from lightfm_tpu_torch.ops import adagrad_update as au
from lightfm_tpu_torch.ops import grad_sums as gs

from test_torch_update import _WALK_CASES, _bf16_np, _segmented_walk, _terms, _walk_case

EPS = 2.0 ** -23


def _case(seed, R, W, M, hot=50, sentinels=0, zero_every=9):
    """Sorted touches with one hot row, zero-gradient touches and
    ``sentinels`` trailing touches at rows >= R with NONZERO gradients."""
    rng = np.random.RandomState(seed)
    sidx = np.sort(rng.randint(0, R, M)).astype(np.int32)
    sidx[:hot] = sidx[0]
    sidx = np.sort(sidx)
    if sentinels:
        sidx[-sentinels:] = np.sort(R + rng.randint(0, 2**30 - R, sentinels))
    swg = rng.randn(M, W).astype(np.float32)
    swg[::zero_every] = 0.0
    return sidx, swg


def _port(sidx, swg, R, precision="highest"):
    return gs.sorted_grad_sums(torch.tensor(sidx), torch.tensor(swg), R, precision).numpy()


def _numpy_sums(sidx, g1, g2, R):
    keep = (sidx >= 0) & (sidx < R)
    W = g1.shape[1]
    s, s2 = np.zeros((R, W)), np.zeros((R, W))
    a, a2 = np.zeros((R, W)), np.zeros((R, W))
    n = np.bincount(sidx[keep], minlength=R)[:, None].astype(np.float64)
    np.add.at(s, sidx[keep], g1[keep].astype(np.float64))
    np.add.at(s2, sidx[keep], g2[keep].astype(np.float64))
    np.add.at(a, sidx[keep], np.abs(g1[keep]).astype(np.float64))
    np.add.at(a2, sidx[keep], np.abs(g2[keep]).astype(np.float64))
    want = np.concatenate([s, s2], axis=1)
    tol = (n + 1) * EPS * np.concatenate([a, a2], axis=1)
    return want, tol


@pytest.mark.parametrize(
    "R, W, M, sentinels",
    [(5000, 16, 700, 0), (3001, 72, 2500, 40), (600, 8, 64, 5)],
    ids=["pallas-test-shape", "ragged-W72", "small"],
)
def test_grad_sums_match_jax_interpret(R, W, M, sentinels):
    sidx, swg = _case(R, R, W, M, sentinels=sentinels)
    got = _port(sidx, swg, R)
    assert got.shape == (R, 2 * W) and got.dtype == np.float32
    want = np.asarray(sorted_grad_sums_pallas(
        jnp.asarray(sidx), jnp.asarray(swg), n_rows=R, interpret=True,
        precision=jax.lax.Precision.HIGHEST,
    ))
    _, tol = _numpy_sums(sidx, swg, swg * swg, R)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    untouched = np.setdiff1d(np.arange(R), sidx[sidx < R])
    assert len(untouched) and (got[untouched] == 0).all() and (want[untouched] == 0).all()


def test_sentinels_and_empty_match_the_pallas_cases():
    """``tests/test_pallas.py:357-381``: an all-sentinel call gives exact
    zeros; real rows sort before the sentinels and sum exactly."""
    R, W, M = 600, 8, 64
    sidx = np.full(M, 10**6, np.int32)
    swg = np.ones((M, W), np.float32)
    assert (_port(sidx, swg, R) == 0).all()
    sidx[:3] = [5, 5, 599]
    sidx = np.sort(sidx)
    S = _port(sidx, swg, R)
    assert S[5, 0] == 2.0 and S[599, 0] == 1.0 and S[5, W] == 2.0
    assert float(np.abs(S).sum()) == 2 * (2.0 + 1.0) * W
    empty = gs.sorted_grad_sums(torch.zeros(0, dtype=torch.int32), torch.zeros(0, W), R)
    assert empty.shape == (R, 2 * W) and not empty.any()


def test_default_precision_rounds_operands_to_bf16():
    R, W = 2000, 72
    sidx, swg = _case(3, R, W, 3000, sentinels=20)
    got = _port(sidx, swg, R, "default")
    want, tol = _numpy_sums(sidx, _bf16_np(swg), _bf16_np(swg * swg), R)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    assert not np.array_equal(got, _port(sidx, swg, R, "highest"))  # rounding applied


def test_touch_order_within_a_run_only_moves_the_sum_order():
    """The plain version ignores the order; reversed runs give the same
    sums to f32 summation order."""
    R, W = 800, 16
    sidx, swg = _case(4, R, W, 1200)
    order = np.lexsort((-np.arange(len(sidx)), sidx))
    got = _port(sidx[order], swg[order], R)
    want, tol = _numpy_sums(sidx, swg, swg * swg, R)
    assert (np.abs(got - want) <= tol).all()


def test_wrapper_checks_arguments_and_counts_no_cpu_launch():
    sidx, swg = (torch.tensor(x) for x in _case(5, 100, 8, 50))
    gs.reset_launches()
    with pytest.raises(TypeError, match="int32"):
        gs.sorted_grad_sums(sidx.long(), swg, 100)
    with pytest.raises(TypeError, match="float32"):
        gs.sorted_grad_sums(sidx, swg.double(), 100)
    with pytest.raises(ValueError, match="rows for"):
        gs.sorted_grad_sums(sidx, swg[:10], 100)
    with pytest.raises(ValueError, match="precision"):
        gs.sorted_grad_sums(sidx, swg, 100, "bf16")
    gs.sorted_grad_sums(sidx, swg, 100)
    assert gs.launches == {"sorted_grad_sums": 0}  # plain versions are not launches


# --- the two-pass kernel's plan and bookkeeping -----------------------------
# K3 is K1's segmented reduction (csrc/segmented.cuh) whose finished runs
# store their sums into the zeroed output instead of applying adagrad; the
# walk of tests/test_torch_update.py runs here with that finish step.


def test_wrapper_uses_k1_scratch_and_alignment():
    assert gs.scratch_shape is au.scratch_shape and gs.aligned is au.aligned
    assert gs.SEGMENT == au.SEGMENT == 64


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("name", list(_WALK_CASES))
def test_two_pass_walk_matches_plain_and_jax(name, precision):
    _, _, idx, wg, want_paths = _walk_case(name)
    R, W = 500, wg.shape[1]
    got = np.zeros((R, 2 * W), np.float32)

    def store(r, s, s2):
        assert not got[r].any()  # each row is finished once
        got[r] = np.concatenate([s, s2])

    g, g2 = _terms(wg, precision)
    paths = _segmented_walk(idx, g, g2, R, store)
    for path, n in want_paths.items():
        assert paths[path] == n, paths  # the case takes the path it is for
    assert np.isfinite(got).all()  # no unwritten slot read
    _, tol = _numpy_sums(idx, g, g2, R)
    plain = _port(idx, wg, R, precision)
    assert (np.abs(got - plain) <= tol).all(), np.abs(got - plain).max()
    keep = (idx >= 0) & (idx < R)
    untouched = np.setdiff1d(np.arange(R), idx[keep])
    assert len(untouched) and not got[untouched].any()
    if precision == "highest":
        # The TPU kernel's contract ignores rows >= n_rows; negative rows are
        # the port's own sentinels, so they are left out of its input.
        nonneg = idx >= 0
        pallas = np.asarray(sorted_grad_sums_pallas(
            jnp.asarray(idx[nonneg]), jnp.asarray(wg[nonneg]), n_rows=R, interpret=True,
            precision=jax.lax.Precision.HIGHEST,
        ))
        assert (np.abs(got - pallas) <= tol).all(), np.abs(got - pallas).max()
