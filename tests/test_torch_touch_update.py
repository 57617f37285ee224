"""The generic step's adagrad pass on the card, held on the CPU.

On a CUDA table ``ops.updates.sparse_update``'s adagrad branch sorts the
table's touches once (``updates.touch_order``: a masked touch keyed past the
last row) and hands them to ``ops.adagrad_update.touch_adagrad_update``, a
hand-written kernel.  The kernel runs only on the card; here its plain
version, fed the keys that ``sparse_update`` builds, is held against
``sparse_update``'s CPU path on the same touches, and a numpy walk of the
kernel's bookkeeping (run-aligned chunks of ``au.CHUNK`` touches, each summed
in touch order; a run's chunk sums added in pass B's fixed order) against
the plain version.  Both sides sum a row's touches in fp32 in their own
order, so they agree within the recursive-summation bound of float32.  The
walk also shows what the kernel's design is for: a row held under a
``"rows"`` or ``"components"`` partition, or a row among masked touches,
gets bitwise the sums it gets on one device with its live touches alone.
"""

import types

import numpy as np
import pytest
import torch

from lightfm_tpu_torch import losses, observability
from lightfm_tpu_torch.ops import adagrad_update as au
from lightfm_tpu_torch.ops import updates
from lightfm_tpu_torch.parallel.mesh import TablePlacement
from lightfm_tpu_torch.state import ModelState

LR = 0.05
C = au.CHUNK
_WARPS = 8  # pass B's block: the fan-in of the tree a run of more than 32 chunks is added in


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    worker processes side by side, and each one's OpenMP pool spinning on
    every core slows all of them by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _touches(rng, R, M, W, hot=None, masked=0.3):
    """M touches of an R-row, W-wide table in touch order: rows from ``hot``
    (a function of rng) or uniform, a share ``masked`` masked, a tenth of
    the weights 0, every 13th gradient row 0."""
    idx = hot(rng) if hot is not None else rng.randint(0, R, M)
    w = rng.choice([1.0, 0.5, 2.0], M).astype(np.float32)
    w[rng.rand(M) < 0.1] = 0.0
    g = rng.randn(M, W).astype(np.float32)
    g[::13] = 0.0
    mask = rng.rand(M) >= masked
    table = (0.1 * rng.randn(R, W)).astype(np.float32)
    acc = (1.0 + rng.rand(R, W)).astype(np.float32)
    return table, acc, idx.astype(np.int64), w, g, mask


def _hot_run(rng):
    """65,536 touches of one row among 20,000 spread over all 64."""
    idx = np.concatenate([np.full(65_536, 17), rng.randint(0, 64, 20_000)])
    return rng.permutation(idx)


def _zipf_tags(rng):
    """Touches of 512 tag rows by Zipf popularity: runs of 1 to thousands."""
    return (rng.zipf(1.2, 20_000) - 1) % 512


# name: (R, M, W, row maker, masked share, partition, parts)
CASES = {
    "hot-run-65536": (64, 85_536, 32, _hot_run, 0.3, None, 1),
    "all-masked": (300, 5_000, 32, None, 1.0, None, 1),
    "masked-mixed": (512, 20_000, 32, _zipf_tags, 0.6, None, 1),
    "rows-outside": (512, 20_000, 32, _zipf_tags, 0.3, None, 1),
    "rows-partition": (512, 20_000, 32, _zipf_tags, 0.3, "rows", 2),
    "components-2": (512, 20_000, 32, _zipf_tags, 0.3, "components", 16),
    "components-8": (512, 20_000, 32, _zipf_tags, 0.3, "components", 4),
    "components-16": (512, 20_000, 32, _zipf_tags, 0.3, "components", 2),
    "user-near-unique": (50_000, 8_192, 32, None, 0.3, None, 1),
}


def _case(name):
    R, M, W, hot, masked, layout, n = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    table, acc, idx, w, g, mask = _touches(rng, R, M, W, hot, masked)
    # "rows-outside": a tenth of the touches are handed to the kernel with
    # keys outside [0, R) (negative, or past R), as live touches would be.
    outside = rng.rand(M) < 0.1 if name == "rows-outside" else np.zeros(M, bool)
    return table, acc, idx, w, g, mask, outside, layout, n


def _parts(table, acc, idx, g, mask, layout, n):
    """What each rank of a (1, n) mesh holds and applies under ``layout``:
    ``(table part, acc part, idx, mask, g, sparse_update kwargs, rows, cols)``
    through ``TablePlacement.own``; the whole table when ``layout`` is None."""
    R, W = table.shape
    t, a, i, m, gg = (torch.tensor(x) for x in (table, acc, idx, mask, g))
    if layout is None:
        return [(t, a, i, m, gg, {}, slice(0, R), slice(0, W))]
    out = []
    for k in range(n):
        size = (R if layout == "rows" else W) // n
        place = TablePlacement(None, layout, k * size, (k + 1) * size, (R, W))
        li, lm, lg, kw = place.own(i, m, gg)
        rows = slice(k * size, (k + 1) * size) if layout == "rows" else slice(0, R)
        cols = slice(k * size, (k + 1) * size) if layout == "components" else slice(0, W)
        out.append((t[rows, cols].contiguous(), a[rows, cols].contiguous(), li, lm,
                    lg.contiguous(), kw, rows, cols))
    return out


def _keys(idx, mask, outside, n_rows):
    """The sorted keys and order the kernel is fed: ``updates.touch_order``,
    with the touches flagged ``outside`` keyed -3 (every third) or
    n_rows + 7."""
    if not outside.any():
        return updates.touch_order(idx, mask, n_rows)
    pos = torch.arange(idx.shape[0])
    out = torch.tensor(outside)
    keys = torch.where(mask, idx, n_rows)
    keys = torch.where(out, torch.where(pos % 3 == 0, -3, n_rows + 7), keys)
    return torch.sort(keys.to(torch.int32), stable=True)


def _bounds(table, acc, rows, wg):
    """Per-element bound on the difference of two fp32 updates that sum a
    row's n touches in different orders: each is within (n + 2) * 2^-23 *
    (its terms' magnitudes) of the exact result."""
    R, W = table.shape
    n = torch.zeros(R, dtype=torch.float64).index_add_(0, rows, torch.ones(rows.shape[0],
                                                                          dtype=torch.float64))
    g = wg.double()
    s_abs = torch.zeros((R, W), dtype=torch.float64).index_add_(0, rows, g.abs())
    s_sq = torch.zeros((R, W), dtype=torch.float64).index_add_(0, rows, g * g)
    scale = 2 * (n[:, None] + 2) * 2.0**-23
    t_tol = scale * (table.double().abs() + LR * torch.rsqrt(acc.double()) * s_abs)
    return t_tol, scale * (acc.double() + s_sq)


def _assert_within(got, want, table0, acc0, skeys, order, wg):
    R = table0.shape[0]
    keep = (skeys >= 0) & (skeys < R)
    rows = skeys[keep].long()
    t_tol, a_tol = _bounds(table0, acc0, rows, wg[order[keep]])
    dt = (got[0].double() - want[0].double()).abs()
    da = (got[1].double() - want[1].double()).abs()
    assert bool((dt <= t_tol).all()), float((dt - t_tol).max())
    assert bool((da <= a_tol).all()), float((da - a_tol).max())
    untouched = torch.ones(R, dtype=torch.bool)
    untouched[rows] = False
    for x, x0 in zip(got, (table0, acc0)):
        assert torch.equal(x[untouched], x0[untouched])


def _run_sums(skeys, order, wg, n_rows):
    """A numpy walk of the kernel's bookkeeping in float32 and in its
    summation orders: every run of keys in [0, n_rows) is cut into chunks of
    C touches from its first one, each summed in touch order from 0; a run
    of one chunk is finished with that sum, one of at most 32 with its chunk
    sums added in order, a longer one in the block's tree (warp w adds
    chunks w, w + 8, ...; the warp sums added in warp order).  Yields
    ``(row, first position, touches, (sum wg | sum wg^2), path)`` a run."""
    skeys, order, wg = skeys.numpy(), order.numpy(), wg.numpy()
    W = wg.shape[1]
    zero = np.zeros((1, 2 * W), np.float32)
    terms = np.concatenate([wg, wg * wg], axis=1)
    if not len(skeys):
        return
    starts = np.flatnonzero(np.r_[True, skeys[1:] != skeys[:-1]])
    for s, e in zip(starts, np.r_[starts[1:], len(skeys)]):
        r = skeys[s]
        if not 0 <= r < n_rows:
            continue
        parts = [np.add.accumulate(np.concatenate([zero, terms[order[c:min(c + C, e)]]]),
                                   axis=0, dtype=np.float32)[-1] for c in range(s, e, C)]
        if len(parts) == 1:
            yield r, s, e - s, parts[0], "one chunk"
        elif len(parts) <= 32:
            yield r, s, e - s, np.add.accumulate(np.concatenate([zero, parts]), axis=0,
                                                 dtype=np.float32)[-1], "warp"
        else:
            sums = [np.add.accumulate(np.concatenate([zero, parts[k::_WARPS]]), axis=0,
                                      dtype=np.float32)[-1] for k in range(_WARPS)]
            yield r, s, e - s, np.add.accumulate(np.stack(sums), axis=0,
                                                 dtype=np.float32)[-1], "block"


def _chunk_walk(table, acc, skeys, order, wg):
    """The kernel's walk (:func:`_run_sums`) with the adagrad step applied
    to each finished run.  Returns the updated copies and how many runs
    took each path."""
    table, acc = table.numpy().copy(), acc.numpy().copy()
    W = table.shape[1]
    lr = np.float32(LR)
    paths = {"one chunk": 0, "warp": 0, "block": 0}
    for r, _, _, tot, path in _run_sums(skeys, order, wg, table.shape[0]):
        paths[path] += 1
        a = acc[r].copy()
        table[r] = table[r] - (lr * (np.float32(1) / np.sqrt(a))) * tot[:W]
        acc[r] = a + tot[W:]
    return (torch.from_numpy(table), torch.from_numpy(acc)), paths


def _wg(w, mask, g):
    return (torch.tensor(w) * mask.to(torch.float32))[:, None] * g


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_sparse_update(name):
    """The plain version, fed the sorted keys sparse_update builds, equals
    sparse_update's CPU path on the same touches within the summation bound;
    untouched rows and every all-masked call change nothing."""
    table, acc, idx, w, g, mask, outside, layout, n = _case(name)
    for t0, a0, i, m, gg, kw, _, _ in _parts(table, acc, idx, g, mask, layout, n):
        live = m & ~torch.tensor(outside)  # sparse_update masks what the kernel skips
        want = updates.sparse_update(
            t0.clone(), a0.clone(), torch.zeros_like(t0), i, torch.tensor(w), gg, live,
            adadelta=False, learning_rate=LR, alpha=0.0, rho=0.95, eps=1e-6, need_stats=False,
            **kw)[:2]
        skeys, order = _keys(i, m, outside, t0.shape[0])
        wg = _wg(w, m, gg)
        got = au.touch_adagrad_update_plain(t0.clone(), a0.clone(), skeys, order, wg, LR)
        _assert_within(got, want, t0, a0, skeys, order, wg)
        if name == "all-masked":
            assert torch.equal(got[0], t0) and torch.equal(got[1], a0)


# The path of pass B each case must exercise (at least this many runs).
_PATHS = {"hot-run-65536": {"block": 1, "warp": 1}, "masked-mixed": {"warp": 5},
          "user-near-unique": {"one chunk": 4_000}, "rows-partition": {"warp": 5},
          "components-2": {"warp": 5}}


@pytest.mark.parametrize("name", list(CASES))
def test_chunk_walk_is_the_one_device_update(name):
    """The kernel's walk equals the plain version within the summation
    bound and takes the path of pass B the case is for; a held part of a
    split table, or a table among masked and outside touches, gets bitwise
    the walk of the whole table with the live touches alone."""
    table, acc, idx, w, g, mask, outside, layout, n = _case(name)
    live = mask & ~outside
    keep = np.flatnonzero(live)
    alone, _ = _chunk_walk(torch.tensor(table), torch.tensor(acc),
                           *updates.touch_order(torch.tensor(idx[keep]), torch.ones(len(keep),
                                                                                    dtype=bool),
                                                table.shape[0]),
                           _wg(w[keep], torch.ones(len(keep), dtype=bool),
                               torch.tensor(g[keep])))
    paths = {}
    for t0, a0, i, m, gg, _, rows, cols in _parts(table, acc, idx, g, mask, layout, n):
        skeys, order = _keys(i, m, outside, t0.shape[0])
        wg = _wg(w, m, gg)
        got, p = _chunk_walk(t0, a0, skeys, order, wg)
        for k, v in p.items():
            paths[k] = paths.get(k, 0) + v
        _assert_within(got, au.touch_adagrad_update_plain(t0.clone(), a0.clone(), skeys, order,
                                                          wg, LR),
                       t0, a0, skeys, order, wg)
        assert torch.equal(got[0], alone[0][rows, cols]) and torch.equal(got[1],
                                                                         alone[1][rows, cols])
    for path, least in _PATHS.get(name, {}).items():
        assert paths[path] >= least, paths


@pytest.mark.parametrize("adadelta", [False, True], ids=["adagrad", "adadelta"])
def test_cuda_dispatch_takes_the_kernel(monkeypatch, adadelta):
    """On a CUDA table sparse_update hands the touches of either schedule,
    keyed by ``touch_order``, to its kernel (here the plain version, through
    the same call), as does the step's pass of a table; the result is the
    CPU path's within the summation bound (adagrad: ``_bounds``; adadelta:
    ``test_torch_touch_adadelta._bounds``) and the L2 statistics agree
    (adagrad's bitwise; adadelta's kernel sums its own, and both lie within
    their bounds of float64).  A stand-in with ``is_cuda`` set takes the
    table's place in the choice."""
    from test_torch_touch_adadelta import _assert_stat
    from test_torch_touch_adadelta import _assert_within as adadelta_within

    table, acc, idx, w, g, mask, _, _, _ = _case("masked-mixed")
    args = [torch.tensor(x) for x in (table, acc, np.zeros_like(acc) + 0.01, idx, w, g, mask)]
    kw = dict(learning_rate=LR, alpha=1e-6, rho=0.95, eps=1e-6, emb_dim=30)
    kernel = "touch_adadelta_update" if adadelta else "touch_adagrad_update"
    calls = []
    launch = getattr(updates, kernel)

    def recorded(*a):
        calls.append(a)
        return launch(*a)

    cpu = updates.sparse_update(*(x.clone() for x in args), adadelta=adadelta, **kw)
    monkeypatch.setattr(updates, kernel, recorded)
    updates.sparse_update(*(x.clone() for x in args), adadelta=adadelta, **kw)
    assert not calls  # a CPU table sums with index_add_
    real = updates.kernel_sums

    def on_card(t, adadelta):
        return real(types.SimpleNamespace(is_cuda=True), adadelta)

    monkeypatch.setattr(updates, "kernel_sums", on_card)
    got = updates.sparse_update(*(x.clone() for x in args), adadelta=adadelta, **kw)
    assert len(calls) == 1
    at = 3 if adadelta else 2  # adadelta's kernel takes mom before the keys
    skeys, order = calls[0][at], calls[0][at + 1]
    assert torch.equal(skeys, updates.touch_order(args[3], args[6], table.shape[0])[0])
    wg = _wg(w, args[6], args[5])
    if adadelta:
        assert calls[0][-1] == (30, 31)  # the statistic's columns: [0, 30) and the bias
        adadelta_within(got[:3], cpu[:3], args[0], args[1], args[2], skeys, order, wg,
                        kw["alpha"])
        _assert_stat(got[3], cpu[3], args[0], args[1], args[2], skeys, order, wg, (30, 31))
    else:
        _assert_within(got[:2], cpu[:2], args[0], args[1], skeys, order, wg)
        assert torch.equal(got[3], cpu[3])
    assert torch.equal(got[4], cpu[4])
    state = ModelState(*(x.clone() for x in args[:3] * 2), torch.tensor(0.0), torch.tensor(0.0))
    step_kw = {k: v for k, v in kw.items() if k != "alpha"}
    losses._apply_touches(state, "item", None, tuple(args[3:]), [], 0.0,
                          dict(step_kw, adadelta=adadelta, need_stats=False), None)
    assert len(calls) == 2  # the step hands its touches to the same kernel


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("schedule", ["adagrad", "adadelta"])
def test_a_generic_fit_on_the_card_keeps_no_update_counter_on_the_device(card, schedule):
    """A generic fit on the card hands each step's touches of both tables to
    its schedule's kernel, and its steps add no count of those touches on
    the device: no reduction a step for a counter that nothing reads."""
    import scipy.sparse as sp

    from lightfm_tpu_torch import LightFM
    from lightfm_tpu_torch.ops import adadelta_update as ad

    rng = np.random.RandomState(2)
    rows = np.repeat(np.arange(300), 6)
    cols = rng.randint(0, 200, rows.size)
    inter = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(300, 200))
    model = LightFM(loss="warp", learning_schedule=schedule, item_alpha=1e-6, no_components=6,
                    batch_size=256, fast_path="off", random_state=4, device="cuda")
    kernels = ad if schedule == "adadelta" else au
    kernels.reset_launches()
    with observability.recording() as rec:
        model.fit(inter, epochs=1)
    torch.cuda.synchronize()
    steps = len(rec.named("step"))
    assert model._staged_fast is False and steps > 0
    assert kernels.launches[f"touch_{schedule}_update"] == 2 * steps
    assert rec.counters["update_touches.item"] > 0 and rec.counters["update_touches.user"] > 0
    assert not [name for name, _ in observability._device_counts
                if name.startswith("update_kernel_touches")]

