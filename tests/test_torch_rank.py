"""lightfm_tpu_torch ranking vs lightfm_tpu ranking, on the CPU.

The port's kernel wrappers take their plain PyTorch versions for CPU
tensors; the JAX side runs the Pallas kernel in interpret mode, as
tests/test_pallas.py does.  Inputs are made with numpy from a seed and fed
to both.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from lightfm_tpu.ops import ranking as jax_ranking
from lightfm_tpu.ops.pallas_rank import rank_counts_fused
from lightfm_tpu.sparse import identity_rows as jax_identity_rows
from lightfm_tpu.state import ModelState as JaxModelState
from lightfm_tpu.state import init_state as jax_init_state

from lightfm_tpu_torch.interop import state_from_numpy
from lightfm_tpu_torch.ops import rank_counts as rc
from lightfm_tpu_torch.ops import ranking
from lightfm_tpu_torch.sparse import identity_rows


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rank_inputs(case):
    rng = np.random.RandomState(0)
    U, I, Wa, T = 16, 256, 9, 8
    if case == "gaussian":
        u = rng.randn(U, Wa).astype(np.float32)
        items = rng.randn(I, Wa).astype(np.float32)
        ts = rng.randn(U, T).astype(np.float32)
    elif case == "zero_ties":
        u = np.zeros((U, Wa), np.float32)
        items = np.zeros((I, Wa), np.float32)
        ts = np.zeros((U, T), np.float32)
    elif case == "inf_pad":
        u = rng.randn(U, Wa).astype(np.float32)
        items = rng.randn(I, Wa).astype(np.float32)
        ts = np.full((U, T), np.inf, np.float32)
    else:  # integer-valued: every dot is exact, ties are plentiful
        u = rng.randint(-2, 3, (U, Wa)).astype(np.float32)
        items = rng.randint(-2, 3, (I, Wa)).astype(np.float32)
        ts = (rng.randint(-16, 17, (U, T)) / 2).astype(np.float32)
    return u, items, ts


@pytest.mark.parametrize("case", ["gaussian", "zero_ties", "inf_pad", "integer"])
def test_rank_counts_plain_matches_pallas(case):
    u, items, ts = _rank_inputs(case)
    want = np.asarray(
        rank_counts_fused(
            jnp.asarray(u), jnp.asarray(items), jnp.asarray(ts),
            user_block=8, item_block=128, interpret=True,
        )
    )
    got = rc.rank_counts(_t(u), _t(items), _t(ts)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if case == "gaussian":
        # Summation order differs between the two f32 GEMMs: measure-zero
        # near-tie flips of +-1 only (the tolerance of tests/test_pallas.py).
        assert np.abs(got - want).max() <= 1
        assert (got == want).mean() >= 0.99
    else:
        assert np.array_equal(got, want)
    if case == "zero_ties":
        assert (got == items.shape[0]).all()
    if case == "inf_pad":
        assert (got == 0).all()


def test_pair_scores_plain_matches_diag_scores():
    rng = np.random.RandomState(2)
    U, C, I, Wa = 16, 5, 64, 9
    u = rng.randn(U, Wa).astype(np.float32)
    items = rng.randn(I, Wa).astype(np.float32)
    idx = rng.randint(0, I, (U, C)).astype(np.int32)
    want = np.asarray(
        jax_ranking._diag_scores(jnp.asarray(u), jnp.asarray(items)[idx], 8)
    )
    got = rc.pair_scores(_t(u), _t(items), _t(idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_wrappers_reject_bad_inputs_and_count_no_cpu_launches():
    rc.reset_launches()
    u = torch.zeros((4, 9))
    with pytest.raises(TypeError):
        rc.rank_counts(u.double(), torch.zeros((8, 9)), torch.zeros((4, 2)))
    with pytest.raises(ValueError):
        rc.rank_counts(u, torch.zeros((8, 7)), torch.zeros((4, 2)))
    with pytest.raises(TypeError):
        rc.pair_scores(u, torch.zeros((8, 9)), torch.zeros((4, 2), dtype=torch.int64))
    rc.rank_counts(u, torch.zeros((8, 9)), torch.zeros((4, 2)))
    assert rc.launches == {"rank_counts": 0, "pair_scores": 0}


def _ranking_case(n_users, n_items, T, no_components, seed, train_lengths):
    """Padded rank inputs exactly as predict_ranks_padded builds them, for
    both packages, plus a JAX-initialised state carried into the port."""
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n_users), T)
    cols = np.concatenate(
        [rng.choice(n_items, T, replace=False) for _ in range(n_users)]
    )
    test = sp.csr_matrix(
        (np.ones(n_users * T, np.float32), (rows, cols)), shape=(n_users, n_items)
    )
    tr_rows = np.repeat(np.arange(n_users), train_lengths)
    tr_cols = np.concatenate(
        [(cols[u * T] + 11 + np.arange(n)) % n_items
         for u, n in enumerate(train_lengths)]
    ).astype(int)
    train = sp.csr_matrix(
        (np.ones(len(tr_rows), np.float32), (tr_rows, tr_cols)),
        shape=(n_users, n_items),
    )
    train = sp.csr_matrix(train - train.multiply(test))
    train.eliminate_zeros()

    jstate = jax_init_state(no_components, n_items, n_users, rng, adagrad=True)
    tstate = state_from_numpy(
        {n: np.asarray(x) for n, x in zip(JaxModelState._fields, jstate)}, "cpu"
    )
    (tier,) = jax_ranking._prepare_rank_tiers(test, train, 16)
    (ttier,) = ranking._prepare_rank_tiers(test, train, 16, torch.device("cpu"))
    for a, b in [(tier.user_ids, ttier.user_ids), (tier.test_idx, ttier.test_idx),
                 (tier.test_valid, ttier.test_valid), (tier.train_idx, ttier.train_idx)]:
        assert np.array_equal(np.asarray(a), b.numpy())
    jargs = (jstate, jax_identity_rows(n_users), jax_identity_rows(n_items),
             tier.user_ids, tier.test_idx, tier.test_valid, tier.train_idx)
    targs = (tstate, identity_rows(n_users), identity_rows(n_items),
             ttier.user_ids, ttier.test_idx, ttier.test_valid, ttier.train_idx)
    return jargs, targs


# (n_users, n_items, T, D, seed, train lengths): the flat-path case of
# tests/test_pallas.py:72 and its exact-multiple-of-item-block case (:230),
# where the exclusion sentinel must still land on a -inf pad row.
_CASES = {
    "ragged_catalog": (48, 300, 5, 16, 0, [5] * 48),
    "exact_block_multiple": (16, 256, 3, 8, 1, [u % 4 for u in range(16)]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("path", ["fused", "flat", "blocked"])
def test_ranks_paths_match_jax(case, path):
    n_users, n_items, T, D, seed, lengths = _CASES[case]
    jargs, targs = _ranking_case(n_users, n_items, T, D, seed, lengths)
    if path == "fused":
        want = jax_ranking._ranks_fused(
            *jargs, n_items=n_items, user_block=16, item_block=128, interpret=True
        )
        got = ranking._ranks_fused(*targs, n_items=n_items, item_block=128)
    elif path == "flat":
        want = jax_ranking._ranks_flat(*jargs, n_items=n_items, user_block=16)
        got = ranking._ranks_flat(*targs, n_items=n_items, user_block=16)
    else:
        want = jax_ranking._ranks_blocked(
            *jargs, n_items=n_items, user_block=16, item_block=128
        )
        got = ranking._ranks_blocked(*targs, n_items=n_items, user_block=16, item_block=128)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape
    # CPU GEMMs of the two frameworks sum in different orders: +-1 on
    # near-ties only (tests/test_pallas.py:138 allows the same).
    assert np.abs(got - want).max() <= 1
    assert (got >= 0).all()
    if path == "fused":
        # In interpret mode the JAX fused path's test scores come from a
        # different GEMM than its counts, so its self match flips often.
        # The port's plain versions share their GEMMs, so its fused ranks
        # are exact: they match the JAX flat path, which reads test scores
        # out of the counted rows.
        want = np.asarray(jax_ranking._ranks_flat(*jargs, n_items=n_items, user_block=16))
    assert (got == want).mean() >= 0.99


def test_wide_tier_sort_path_matches_jax():
    # T > COUNT_T_LIMIT ranks by sort + searchsorted (every item of a user).
    n_users, n_items = 4, 200
    jargs, targs = _ranking_case(n_users, n_items, 40, 8, 3, [0] * n_users)
    want = np.asarray(jax_ranking._ranks_flat(*jargs, n_items=n_items, user_block=4))
    got = ranking._ranks_flat(*targs, n_items=n_items, user_block=4).numpy()
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= 0.99


def test_predict_ranks_padded_heavy_tier_matches_jax():
    """One user with ~100x the typical train degree gets its own tier."""
    rng = np.random.RandomState(0)
    n_users, n_items = 60, 500
    rows, cols = [], []
    for u in range(n_users):
        deg = 400 if u == 7 else rng.randint(2, 6)
        rows.extend([u] * deg)
        cols.extend(rng.choice(n_items, size=deg, replace=False))
    train = sp.csr_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)), shape=(n_users, n_items)
    )
    test = sp.csr_matrix(
        (np.ones(150, np.float32),
         (rng.randint(0, n_users, 150), rng.randint(0, n_items, 150))),
        shape=(n_users, n_items),
    )
    test.data[:] = 1.0
    test = sp.csr_matrix(test - test.multiply(train))
    test.eliminate_zeros()

    users = np.flatnonzero(np.diff(test.indptr) > 0)
    assert len(ranking._split_degree_tiers(np.diff(train.indptr), users)) == 2

    jstate = jax_init_state(8, n_items, n_users, rng, adagrad=True)
    tstate = state_from_numpy(
        {n: np.asarray(x) for n, x in zip(JaxModelState._fields, jstate)}, "cpu"
    )
    want = jax_ranking.predict_ranks_padded(
        jstate, jax_identity_rows(n_users), jax_identity_rows(n_items), test, train
    )
    cache = {}
    rc.reset_launches()
    got = ranking.predict_ranks_padded(
        tstate, identity_rows(n_users), identity_rows(n_items), test, train,
        cache=cache,
    )
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= 0.99
    # CPU tensors never launch a kernel; the prep is memoized.
    assert rc.launches == {"rank_counts": 0, "pair_scores": 0}
    again = ranking.predict_ranks_padded(
        tstate, identity_rows(n_users), identity_rows(n_items), test, train,
        cache=cache,
    )
    assert np.array_equal(got, again)
    assert sum(1 for k in cache if k[0] == "rank_prep") == 1
