"""K1/K4 (lightfm_tpu_torch.ops.adagrad_update) vs the JAX package, on the CPU.

The port's wrappers take their plain versions for CPU tensors; they are held
against ``sorted_adagrad_update_pallas``/``adagrad_update_pallas`` run in
Pallas interpret mode (as ``tests/test_pallas.py`` runs them) and against
``fast_warp._sorted_update(use_pallas=False)``.

Tolerance ("f32 summation order"): per element
``|got - want| <= (n_r + 2) * 2^-23 * (|table| + lr * rsqrt(acc) * sum|wg|)``
for the table and ``(n_r + 2) * 2^-23 * (acc + sum wg^2)`` for the
accumulator, where ``n_r`` is the row's touch count: the worst case of
recursive fp32 summation of n_r terms, plus the final multiply and add.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightfm_tpu import fast_warp as jax_fw
from lightfm_tpu.ops.pallas_update import adagrad_update_pallas, sorted_adagrad_update_pallas

from lightfm_tpu_torch.ops import adagrad_update as au

LR = 0.05
EPS = 2.0 ** -23


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    worker processes side by side, and each one's OpenMP pool spinning on
    every core slows all of them by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, R, W, M, hot=True, sentinels=0, zero_every=11):
    """Sorted touches with hot rows, zero-gradient touches and ``sentinels``
    trailing touches at rows >= R that carry NONZERO gradients."""
    rng = np.random.RandomState(seed)
    table = rng.randn(R, W).astype(np.float32)
    acc = (1.0 + rng.rand(R, W)).astype(np.float32)
    idx = rng.randint(0, R, M).astype(np.int32)
    if hot:
        idx[: M // 3] = rng.randint(0, 5, M // 3)  # a few rows with hundreds of touches
    idx = np.sort(idx)
    if sentinels:
        idx[-sentinels:] = R + rng.randint(0, 2**30 - R, sentinels)
        idx[-sentinels:] = np.sort(idx[-sentinels:])
    wg = rng.randn(M, W).astype(np.float32)
    wg[::zero_every] = 0.0
    return table, acc, idx, wg


def _tolerances(table, acc, idx, wg):
    R = table.shape[0]
    ok = idx < R
    counts = np.bincount(idx[ok], minlength=R)[:, None].astype(np.float64)
    abs_sum = np.zeros(table.shape)
    sq_sum = np.zeros(table.shape)
    np.add.at(abs_sum, idx[ok], np.abs(wg[ok]).astype(np.float64))
    np.add.at(sq_sum, idx[ok], (wg[ok].astype(np.float64)) ** 2)
    t_tol = (counts + 2) * EPS * (np.abs(table) + LR / np.sqrt(acc) * abs_sum)
    a_tol = (counts + 2) * EPS * (acc + sq_sum)
    return t_tol, a_tol


def _port(fn, table, acc, idx, wg, precision="highest"):
    t, a = torch.tensor(table), torch.tensor(acc)
    out_t, out_a = fn(t, a, torch.tensor(idx), torch.tensor(wg), LR, precision)
    assert out_t is t and out_a is a  # updated in place
    return t.numpy(), a.numpy()


def _assert_close(got, want, tol):
    got_t, got_a = got
    want_t, want_a = (np.asarray(x) for x in want)
    t_tol, a_tol = tol
    assert (np.abs(got_t - want_t) <= t_tol).all(), np.abs(got_t - want_t).max()
    assert (np.abs(got_a - want_a) <= a_tol).all(), np.abs(got_a - want_a).max()


@pytest.mark.parametrize(
    "R, W, M, sentinels",
    [(1000, 16, 300, 0), (3001, 72, 2500, 40), (7000, 24, 5000, 7)],
    ids=["small", "ragged-W72", "multiblock"],
)
def test_sorted_update_matches_jax(R, W, M, sentinels):
    table, acc, idx, wg = _case(R, R, W, M, sentinels=sentinels)
    got = _port(au.sorted_adagrad_update, table, acc, idx, wg)
    tol = _tolerances(table, acc, idx, wg)
    pallas = sorted_adagrad_update_pallas(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(idx), jnp.asarray(wg),
        learning_rate=LR, interpret=True, precision=jax.lax.Precision.HIGHEST,
    )
    _assert_close(got, pallas, tol)
    # fast_warp's XLA formulation takes rows < R only (sentinels are the
    # Pallas kernel's contract), so hand it the in-range touches.
    keep = idx < R
    xla = jax_fw._sorted_update(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(idx[keep]),
        jnp.asarray(wg[keep]), LR, use_pallas=False,
    )
    _assert_close(got, xla, tol)
    # Rows no in-range touch hits are bitwise unchanged.
    untouched = np.setdiff1d(np.arange(R), idx[keep])
    assert len(untouched) > 0
    assert np.array_equal(got[0][untouched], table[untouched])
    assert np.array_equal(got[1][untouched], acc[untouched])


def test_sentinel_touches_are_ignored():
    table, acc, idx, wg = _case(1, 500, 16, 400, sentinels=50)
    got = _port(au.sorted_adagrad_update, table, acc, idx, wg)
    keep = idx < 500
    want = _port(au.sorted_adagrad_update, table, acc, idx[keep], wg[keep])
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["zero-gradients", "all-sentinels", "empty"])
def test_all_masked_call_is_a_noop(kind):
    table, acc, idx, wg = _case(2, 300, 8, 200)
    if kind == "zero-gradients":
        wg = np.zeros_like(wg)
    elif kind == "all-sentinels":
        idx = np.full_like(idx, 2**30)
    else:
        idx, wg = idx[:0], wg[:0]
    got = _port(au.sorted_adagrad_update, table, acc, idx, wg)
    assert np.array_equal(got[0], table) and np.array_equal(got[1], acc)


def _bf16_np(x):
    """Round float32 to bf16, nearest even, and back (finite inputs)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def test_default_precision_rounds_gradients_to_bf16():
    """``"default"``: each wg and wg*wg (fp32) rounds to bf16 before the fp32
    sum -- a numpy float64 model of that rounding, same tolerance."""
    table, acc, idx, wg = _case(3, 2000, 72, 3000, sentinels=20)
    got = _port(au.sorted_adagrad_update, table, acc, idx, wg, "default")
    R = table.shape[0]
    keep = idx < R
    g = _bf16_np(wg[keep]).astype(np.float64)
    g2 = _bf16_np(wg[keep] * wg[keep]).astype(np.float64)
    s, s2 = np.zeros(table.shape), np.zeros(table.shape)
    np.add.at(s, idx[keep], g)
    np.add.at(s2, idx[keep], g2)
    want = (table - LR / np.sqrt(acc) * s, acc + s2)
    _assert_close(got, want, _tolerances(table, acc, idx, wg))
    # ... and it differs from "highest" (the rounding is really applied).
    highest = _port(au.sorted_adagrad_update, table, acc, idx, wg, "highest")
    assert not np.array_equal(got[0], highest[0])


def test_unsorted_update_matches_jax():
    """K4: argsort + K1, against ``adagrad_update_pallas`` (interpret)."""
    rng = np.random.RandomState(4)
    R, W, M = 4000, 24, 3000
    table = rng.randn(R, W).astype(np.float32)
    acc = (1.0 + rng.rand(R, W)).astype(np.float32)
    idx = rng.randint(0, R, M).astype(np.int32)
    idx[::5] = rng.randint(0, 7, len(idx[::5]))  # hot rows, scattered
    wg = rng.randn(M, W).astype(np.float32)
    wg[::13] = 0.0
    got = _port(au.adagrad_update, table, acc, idx, wg)
    want = adagrad_update_pallas(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(idx), jnp.asarray(wg),
        learning_rate=LR, interpret=True,
    )
    _assert_close(got, want, _tolerances(table, acc, idx, wg))
    order = np.argsort(idx, kind="stable")
    sorted_got = _port(au.sorted_adagrad_update, table, acc, idx[order], wg[order])
    assert np.array_equal(got[0], sorted_got[0]) and np.array_equal(got[1], sorted_got[1])


def test_wrappers_check_arguments_and_count_no_cpu_launch():
    table, acc, idx, wg = (torch.tensor(x) for x in _case(5, 100, 8, 50))
    au.reset_launches()
    with pytest.raises(TypeError, match="int32"):
        au.sorted_adagrad_update(table, acc, idx.long(), wg, LR)
    with pytest.raises(TypeError, match="float32"):
        au.adagrad_update(table.double(), acc, idx, wg, LR)
    with pytest.raises(ValueError, match="wg must be"):
        au.sorted_adagrad_update(table, acc, idx, wg[:, :4], LR)
    with pytest.raises(ValueError, match="acc"):
        au.sorted_adagrad_update(table, acc[:10], idx, wg, LR)
    with pytest.raises(ValueError, match="precision"):
        au.sorted_adagrad_update(table, acc, idx, wg, LR, "bf16")
    au.sorted_adagrad_update(table, acc, idx, wg, LR)
    au.adagrad_update(table, acc, idx, wg, LR)
    # Plain versions are not kernel launches.
    assert au.launches == {"sorted_adagrad_update": 0, "adagrad_update": 0}
