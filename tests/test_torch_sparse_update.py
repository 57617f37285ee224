"""lightfm_tpu_torch.ops.updates.sparse_update vs lightfm_tpu.ops.updates, on the CPU.

The same table, accumulators and touches go through both functions.  Every
table, accumulator and momentum entry, and the statistics ``sum_lr`` and
``n_touches``, agree within ``1e-6 + 1e-6 * |x|`` (the two packages sum
duplicate touches in different orders).  The JAX function has a one-hot
branch for tables of at most 2^19 elements when no statistics are needed;
the port has one function, held against both regimes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightfm_tpu.ops import updates as jax_updates

from lightfm_tpu_torch.ops import updates


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(R, W, M, seed, adadelta=False, one_d=False):
    """A table with duplicate, masked and zero-weight touches: half the
    touches land on 8 hot rows, a fifth are masked, a tenth weigh 0."""
    rng = np.random.RandomState(seed)
    shape = (R,) if one_d else (R, W)
    table = (rng.randn(*shape) * 0.1).astype(np.float32)
    if adadelta:
        acc = (rng.rand(*shape) * 0.5).astype(np.float32)
        mom = (rng.rand(*shape) * 0.01).astype(np.float32)
    else:
        acc = (1.0 + rng.rand(*shape)).astype(np.float32)
        mom = np.zeros(shape, np.float32)
    idx = np.where(rng.rand(M) < 0.5, rng.randint(0, 8, M), rng.randint(0, R, M)).astype(np.int32)
    w = rng.choice([1.0, 0.5, 2.0], M).astype(np.float32)
    w[rng.rand(M) < 0.1] = 0.0
    g = (rng.randn(M) if one_d else rng.randn(M, W)).astype(np.float32)
    mask = rng.rand(M) >= 0.2
    return table, acc, mom, idx, w, g, mask


def _run_both(arrays, **kw):
    table, acc, mom, idx, w, g, mask = arrays
    want = jax_updates.sparse_update(*(jnp.asarray(a) for a in arrays), **kw)
    kw.pop("need_stats", None)
    got = updates.sparse_update(*(torch.tensor(a) for a in arrays), **kw)
    return got, want


def _assert_close(got, want, tol=1e-6):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape
    err = np.abs(g - w) - tol * np.abs(w)
    assert (err <= tol).all(), float(err.max())


@pytest.mark.parametrize("adadelta", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.1])
@pytest.mark.parametrize("emb_dim", [None, 10])
def test_matches_jax(adadelta, alpha, emb_dim):
    """Both schedules, with and without lazy L2, on a W = 16 table whose
    columns 10..14 are padding when ``emb_dim`` = 10."""
    arrays = _case(500, 16, 600, seed=3, adadelta=adadelta)
    kw = dict(adadelta=adadelta, learning_rate=0.05, alpha=alpha, rho=0.95, eps=1e-6,
              emb_dim=emb_dim)
    got, want = _run_both(arrays, **kw)
    for a, b in zip(got, want):
        _assert_close(a, b)
    # The step really moved every array it owns.
    assert not np.array_equal(got[0].numpy(), arrays[0])
    assert not np.array_equal(got[1].numpy(), arrays[1])
    if adadelta:
        assert not np.array_equal(got[2].numpy(), arrays[2])


@pytest.mark.parametrize("adadelta", [False, True])
def test_one_dimensional_tables(adadelta):
    arrays = _case(300, 1, 400, seed=5, adadelta=adadelta, one_d=True)
    kw = dict(adadelta=adadelta, learning_rate=0.1, alpha=0.05, rho=0.9, eps=1e-6)
    got, want = _run_both(arrays, **kw)
    assert got[0].dim() == 1
    for a, b in zip(got, want):
        _assert_close(a, b)


@pytest.mark.parametrize("R, W", [(2000, 16), (70_000, 8)])
def test_both_sides_of_the_jax_one_hot_threshold(R, W):
    """With no statistics needed, the JAX function takes its one-hot branch
    at R*W <= 2^19 and its scatters above; the port's one function agrees
    with both."""
    arrays = _case(R, W, 1500, seed=7)
    one_hot = R * W <= (1 << 19)
    kw = dict(adadelta=False, learning_rate=0.05, alpha=0.0, rho=0.95, eps=1e-6, emb_dim=W - 2,
              need_stats=False)
    got, want = _run_both(arrays, **kw)
    if one_hot:  # the JAX branch returns zero statistics
        assert float(want[3]) == 0.0 and float(want[4]) == 0.0
    for a, b in zip(got[:3], want[:3]):
        _assert_close(a, b)
    stats = updates.sparse_update(*(torch.tensor(a) for a in arrays), **{
        k: v for k, v in kw.items() if k != "need_stats"}, need_stats=False)
    assert stats[3] is None and stats[4] is None


def test_masked_and_zero_weight_touches_are_exact_noops():
    R, W = 50, 8
    table, acc, mom, idx, w, g, mask = _case(R, W, 200, seed=9, adadelta=True)
    mask[:] = False
    mask[idx == 3] = True  # only row 3 moves
    w[idx == 4] = 0.0
    for adadelta in (False, True):
        t, a, m = (torch.tensor(x) for x in (table, acc, mom))
        updates.sparse_update(t, a, m, torch.tensor(idx), torch.tensor(w), torch.tensor(g),
                              torch.tensor(mask), adadelta=adadelta, learning_rate=0.05,
                              alpha=0.1, rho=0.95, eps=1e-6)
        keep = np.arange(R) != 3
        assert np.array_equal(t.numpy()[keep], table[keep])
        assert np.array_equal(a.numpy()[keep], acc[keep])
        assert np.array_equal(m.numpy()[keep], mom[keep])
        assert not np.array_equal(t.numpy()[3], table[3])


def test_adadelta_decays_once_per_touch():
    """A row touched c times by zero gradients decays by rho^c (the JAX
    code's ``acc.at[idx].mul``), not once per batch."""
    t = torch.zeros(4, 8)
    a = torch.ones(4, 8)
    m = torch.ones(4, 8)
    idx = torch.tensor([1, 1, 1, 2])
    updates.sparse_update(t, a, m, idx, torch.ones(4), torch.zeros(4, 8),
                          torch.tensor([True, True, True, False]), adadelta=True,
                          learning_rate=0.05, alpha=0.0, rho=0.5, eps=1e-6)
    assert torch.equal(a[1], torch.full((8,), 0.125))
    assert torch.equal(a[2], torch.ones(8)) and torch.equal(m[1], torch.full((8,), 0.125))


def test_scatter_mul_order_does_not_matter():
    """The scatter-multiply claim of the module docstring: factors equal per
    (row, column), or exactly 1, give the same bits in any order."""
    rng = np.random.RandomState(0)
    base = torch.tensor(rng.randn(30, 8).astype(np.float32))
    idx = torch.tensor(rng.randint(0, 30, 500))
    per_row = torch.tensor((1 + 0.01 * rng.rand(30, 8)).astype(np.float32))
    keep = torch.tensor(rng.rand(500) < 0.7)
    factors = torch.where(keep[:, None], per_row[idx], torch.ones(8))
    want = base.clone()
    updates.scatter_mul(want, idx, factors)
    for seed in range(3):
        order = torch.randperm(500, generator=torch.Generator().manual_seed(seed))
        got = base.clone()
        updates.scatter_mul(got, idx[order], factors[order])
        assert torch.equal(got, want)


@pytest.mark.parametrize("width, full_width, padded", [
    (18, 72, True), (1, 72, True), (32, 33, True),
    (36, 72, False), (33, 72, False), (16, 16, False), (72, None, False), (18, None, False),
])
def test_accumulate_rows_pads_a_narrow_component_part(monkeypatch, width, full_width, padded):
    """A part of at most 32 columns of a wider table adds through a copy
    padded past 32 columns (on CUDA its duplicates then add in the whole
    width's order); the pad drops out: on the CPU, whose sums do not depend
    on the width, they are a plain ``index_put_``'s."""
    pads = []
    real_pad = torch.nn.functional.pad
    monkeypatch.setattr(torch.nn.functional, "pad",
                        lambda x, p, *a, **k: pads.append(p) or real_pad(x, p, *a, **k))
    rng = np.random.RandomState(width)
    base = torch.tensor(rng.randn(50, width).astype(np.float32))
    rows = torch.tensor(rng.randint(0, 50, 400))  # every row touched ~8 times
    vals = torch.tensor(rng.randn(400, width).astype(np.float32))
    want = base.clone()
    want.index_put_((rows,), vals, accumulate=True)
    got = base.clone()
    updates.accumulate_rows(got, rows, vals, full_width)
    assert torch.equal(got, want)
    assert pads == ([(0, 33 - width)] * 2 if padded else [])

