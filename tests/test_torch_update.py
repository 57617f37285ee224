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
    ok = (idx >= 0) & (idx < R)
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


# --- the two-pass kernel's plan and bookkeeping -----------------------------
# The card's kernel cuts the M sorted touches into segments of au.SEGMENT
# positions (pass A) and adds the partial sums of the runs that cross a
# segment edge in an ordered second pass (pass B).  The kernel runs only on
# the card; its launch plan and a numpy walk of its segments and partials
# are held here.

L = au.SEGMENT


@pytest.mark.parametrize("W", [8, 40, 72, 136])
@pytest.mark.parametrize("M", [1, L - 1, L, L + 1, 131_072])
def test_scratch_shape(M, W):
    segments, slots, width = au.scratch_shape(M, W)
    assert (segments - 1) * L < M <= segments * L  # every touch, once
    assert (slots, width) == (2, 2 * W)  # entering and leaving run: (sum wg | sum wg^2)
    with pytest.raises(ValueError):
        au.scratch_shape(0, W)


def test_aligned_copies_only_a_misaligned_view():
    buf = torch.arange(4 * 40 + 1, dtype=torch.float32)
    whole = buf[:-1].view(4, 40)
    assert au.aligned(whole) is whole
    view = buf[1:].view(4, 40)  # 4 bytes past the allocation's start
    got = au.aligned(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, view)


# Pass B's block: the fan-in of the fixed tree a run of more than 32
# partials is added in (kWarps in the source).
_WARPS = 8


def _segmented_walk(idx, g, g2, R, finish):
    """A numpy walk of the segmented kernels' bookkeeping (K1 and K3 share
    it, ``csrc/segmented.cuh``), in float32 and in the kernels' summation
    orders, over the float32 terms ``g`` and ``g2`` [M, W]: pass A sums
    every run of a segment in touch order and finishes the runs that begin
    and end inside it; the run that enters the segment and the one that
    leaves it become partial rows (slots 0 and 1 of a NaN-filled scratch, so
    a slot read before it is written shows).  Pass B: the segment where a
    leaving run starts adds the run's partials, in order for at most 32 of
    them, else in the block's tree (warp w sums partials w, w + 8, ...; warp
    sums added in warp order), and finishes it.  ``finish(r, s, s2)`` is what
    a finished run does.  Returns how many runs took each path."""
    M, W = g.shape
    n_seg = -(-M // L)
    part = np.full((n_seg, 2, 2 * W), np.nan, np.float32)
    paths = {"inside": 0, "warp": 0, "block": 0}
    for seg in range(n_seg):
        j0 = seg * L
        ids = idx[j0 : j0 + L]
        n = ids.shape[0]
        starts = [0] + [i for i in range(1, n) if ids[i] != ids[i - 1]] + [n]
        entered = j0 > 0 and idx[j0 - 1] == ids[0]
        leaves = j0 + n < M and idx[j0 + n] == ids[-1]
        for k in range(len(starts) - 1):
            r = ids[starts[k]]
            if r < 0 or r >= R:
                continue
            s = np.zeros(W, np.float32)
            s2 = np.zeros(W, np.float32)
            for p in range(j0 + starts[k], j0 + starts[k + 1]):
                s += g[p]
                s2 += g2[p]
            head, tail = k == 0 and entered, k == len(starts) - 2 and leaves
            if head or tail:
                part[seg, 0 if head else 1] = np.concatenate([s, s2])
            else:
                finish(r, s, s2)
                paths["inside"] += 1
    for seg in range(n_seg - 1):
        end = (seg + 1) * L
        r = idx[end - 1]
        if not (0 <= r < R and idx[end] == r) or (seg > 0 and idx[seg * L - 1] == r):
            continue
        n_parts = 1
        while seg + n_parts < n_seg and idx[(seg + n_parts) * L] == r:
            n_parts += 1
        rows = [part[seg, 1]] + [part[seg + p, 0] for p in range(1, n_parts)]
        if n_parts <= 32:
            tot = np.zeros(2 * W, np.float32)
            for row in rows:
                tot = tot + row
            paths["warp"] += 1
        else:
            sums = []
            for w in range(_WARPS):
                acc_w = np.zeros(2 * W, np.float32)
                for row in rows[w::_WARPS]:
                    acc_w = acc_w + row
                sums.append(acc_w)
            tot = sums[0]
            for acc_w in sums[1:]:
                tot = tot + acc_w
            paths["block"] += 1
        finish(r, tot[:W], tot[W:])
    return paths


def _terms(wg, precision):
    """The float32 terms both kernels sum: wg and wg * wg, each rounded to
    bf16 at ``"default"``."""
    g = wg.astype(np.float32)
    g2 = g * g
    if precision == "default":
        g, g2 = _bf16_np(g), _bf16_np(g2)
    return g, g2


def _two_pass(table, acc, idx, wg, precision):
    """K1's walk: :func:`_segmented_walk` whose finished runs take the
    adagrad step with the pre-call acc.  Returns the updated copies and how
    many runs took each path."""
    table, acc = table.copy(), acc.copy()
    lr = np.float32(LR)

    def apply(r, s, s2):
        a = acc[r].copy()
        step = (lr * (np.float32(1) / np.sqrt(a))) * s
        table[r] = table[r] - step
        acc[r] = a + s2

    paths = _segmented_walk(idx, *_terms(wg, precision), table.shape[0], apply)
    return (table, acc), paths


def _runs(*runs):
    """Sorted touches from (row, length) runs."""
    return np.concatenate([np.full(n, r, np.int32) for r, n in runs])


_R = 500
_WALK_CASES = {
    # Runs of exactly L from two edges (they end on edges), L - 1 and L + 1
    # from edges, a run of 1; the run of L + 1 crosses one edge.
    "runs-end-on-edges": (_runs((3, L), (4, L), (5, L - 1), (6, 1), (7, L + 1), (8, L - 1)),
                          {"inside": 5, "warp": 1}),
    "run-crosses-one-edge": (_runs((1, 7), (2, L - 10), (3, 30), (4, 37)),
                             {"inside": 3, "warp": 1}),
    "run-crosses-many-edges": (_runs((1, 30), (2, 5 * L), (3, 34)), {"inside": 2, "warp": 1}),
    "run-crosses-40-edges": (_runs((1, 5), (2, 40 * L), (3, 11)), {"inside": 2, "block": 1}),
    "whole-batch-one-row": (_runs((9, 3 * L + 17)), {"inside": 0, "warp": 1}),
    # Negative rows sort first and rows >= R last; both are ignored.
    "sentinel-runs-cross-edges": (
        _runs((-3, L + 5), (-1, L - 2), (10, 3), (11, L), (_R, L + 9), (_R + 4, 2 * L + 1)),
        {"inside": 1, "warp": 1},
    ),
    "ragged-M": (None, {}),
}


def _walk_case(name, W=8):
    rng = np.random.RandomState(11)
    idx, want_paths = _WALK_CASES[name]
    if idx is None:  # M not a multiple of L: random runs of 1 to 150 touches
        lengths = rng.randint(1, 151, 60)
        idx = _runs(*zip(np.sort(rng.choice(_R, 60, replace=False)), lengths))
        assert idx.shape[0] % L
    table = rng.randn(_R, W).astype(np.float32)
    acc = (1.0 + rng.rand(_R, W)).astype(np.float32)
    wg = rng.randn(idx.shape[0], W).astype(np.float32)
    wg[::7] = 0.0
    return table, acc, idx.astype(np.int32), wg, want_paths


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("name", list(_WALK_CASES))
def test_two_pass_walk_matches_plain_and_jax(name, precision):
    table, acc, idx, wg, want_paths = _walk_case(name)
    got, paths = _two_pass(table, acc, idx, wg, precision)
    for path, n in want_paths.items():
        assert paths[path] == n, paths  # the case takes the path it is for
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()  # no unwritten slot read
    tol = _tolerances(table, acc, idx, wg)
    _assert_close(got, _port(au.sorted_adagrad_update, table, acc, idx, wg, precision), tol)
    keep = (idx >= 0) & (idx < _R)
    untouched = np.setdiff1d(np.arange(_R), idx[keep])
    assert np.array_equal(got[0][untouched], table[untouched])
    assert np.array_equal(got[1][untouched], acc[untouched])
    if precision == "highest":
        # The TPU kernel's contract ignores rows >= R; negative rows are the
        # port's own sentinels, so they are left out of its input.
        nonneg = idx >= 0
        pallas = sorted_adagrad_update_pallas(
            jnp.asarray(table), jnp.asarray(acc), jnp.asarray(idx[nonneg]),
            jnp.asarray(wg[nonneg]), learning_rate=LR, interpret=True,
            precision=jax.lax.Precision.HIGHEST,
        )
        _assert_close(got, pallas, tol)
