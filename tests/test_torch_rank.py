"""lightfm_tpu_torch ranking vs lightfm_tpu ranking, on the CPU.

The port's kernel wrappers take their plain PyTorch versions for CPU
tensors; the JAX side runs the Pallas kernel in interpret mode, as
tests/test_pallas.py does.  Inputs are made with numpy from a seed and fed
to both.  The last tests hold ``predict_rank``'s content-keyed memo against
a model with an empty serving cache.
"""

import pickle

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

from lightfm_tpu_torch import LightFM, observability
from lightfm_tpu_torch.interop import state_from_numpy
from lightfm_tpu_torch.ops import rank_counts as rc
from lightfm_tpu_torch.ops import ranking
from lightfm_tpu_torch.sparse import Memo, identity_rows


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
    memo = Memo(cap=16)
    rc.reset_launches()
    got = ranking.predict_ranks_padded(
        tstate, identity_rows(n_users), identity_rows(n_items), test, train,
        memo=memo,
    )
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= 0.99
    # CPU tensors never launch a kernel; the prep is memoized.
    assert rc.launches == {"rank_counts": 0, "pair_scores": 0}
    again = ranking.predict_ranks_padded(
        tstate, identity_rows(n_users), identity_rows(n_items), test, train,
        memo=memo,
    )
    assert np.array_equal(got, again)
    assert sum(1 for k in memo._entries if k[0] == "rank_prep") == 1


# ---------------------------------------------------------------------------
# predict_rank's content-keyed memo: one content key a matrix a call, under
# which the conversions, the intersection count and the staged tiers are kept.
# ---------------------------------------------------------------------------

_MEMO_USERS, _MEMO_ITEMS = 30, 50


def _memo_pair():
    """Disjoint float32 CSRs, with rows planted for the in-place edits: train
    row 0 is [10, 20, 30] beside test [25, 35]; train row 1 [33, 38] beside
    test [5, 30]; train row 2 holds an explicit zero at test's item 7."""
    rng = np.random.RandomState(11)
    train_rows = {0: [10, 20, 30], 1: [33, 38], 2: [3, 7, 12]}
    test_rows = {0: [25, 35], 1: [5, 30], 2: [7, 15]}
    for u in range(3, _MEMO_USERS):
        items = rng.permutation(_MEMO_ITEMS)
        train_rows[u], test_rows[u] = sorted(items[:5]), sorted(items[5:7])

    def csr(rows):
        indptr = np.cumsum([0] + [len(rows[u]) for u in range(_MEMO_USERS)])
        indices = np.concatenate([rows[u] for u in range(_MEMO_USERS)])
        data = np.ones(len(indices), np.float32)
        return sp.csr_matrix((data, indices, indptr), shape=(_MEMO_USERS, _MEMO_ITEMS))

    train, test = csr(train_rows), csr(test_rows)
    train.data[6] = 0.0  # (2, 7): stored, but no interaction
    return train, test


@pytest.fixture(scope="module")
def memo_model():
    train, _ = _memo_pair()
    return LightFM(loss="warp", no_components=8, random_state=3, device="cpu").fit(
        train, epochs=1)


def _fresh(model):
    """The same model with an empty serving cache."""
    return pickle.loads(pickle.dumps(model))


def _structure_bytes(m):
    """Bytes of the arrays a content key hashes."""
    if sp.isspmatrix_coo(m):
        return m.data.nbytes + m.col.nbytes + m.row.nbytes
    return m.data.nbytes + m.indices.nbytes + m.indptr.nbytes


@pytest.mark.parametrize("test_format,train_format", [
    ("csr32", "csr32"),  # both conversions no-ops
    ("coo32", "csr64"),
    ("csr64", "coo32"),
])
def test_a_repeated_predict_rank_hashes_each_matrix_once_and_reuses_the_count(
        memo_model, monkeypatch, test_format, train_format):
    def fmt(m, f):
        m = m.astype(np.float64 if f.endswith("64") else np.float32)
        return m.tocoo() if f.startswith("coo") else m

    train, test = _memo_pair()
    train, test = fmt(train, train_format), fmt(test, test_format)
    model = _fresh(memo_model)
    multiplied = []
    multiply = type(test).multiply

    def spy(self, other):
        multiplied.append(1)
        return multiply(self, other)

    monkeypatch.setattr(type(test), "multiply", spy)
    with observability.recording() as first:
        a = model.predict_rank(test, train_interactions=train)
    with observability.recording() as second:
        b = model.predict_rank(test, train_interactions=train)
    assert len(multiplied) == 1
    assert first.counters["intersection_misses"] == 1 and "intersection_hits" not in first.counters
    assert second.counters["intersection_hits"] == 1 and "intersection_misses" not in second.counters
    assert second.counters["rank_prep_hits"] == 1 and "rank_prep_misses" not in second.counters
    for rec in (first, second):
        assert rec.counters["fingerprint_bytes"] == _structure_bytes(test) + _structure_bytes(train)
        assert len(rec.named("fingerprint")) == 2
        (check,) = rec.named("predict_rank.intersections")
        assert not [s for s in rec.named("fingerprint")
                    if check.start_ns <= s.start_ns < check.end_ns]
    want = _fresh(memo_model).predict_rank(test, train_interactions=train)
    for got in (a, b):
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        assert got.data.tobytes() == want.data.tobytes()


def _edit_indices(train):
    train.indices[1] = 25  # train (0, 20) -> (0, 25), a test item of row 0


def _edit_data(train):
    train.data[6] = 1.0  # the explicit zero at (2, 7) becomes an interaction


def _edit_indptr(train):
    train.indptr[1] -= 1  # train (0, 30) -> (1, 30), a test item of row 1


@pytest.mark.parametrize("edit", [_edit_indices, _edit_data, _edit_indptr],
                         ids=["indices", "data", "indptr"])
def test_an_edit_in_place_that_makes_an_overlap_raises_as_for_a_fresh_model(memo_model, edit):
    train, test = _memo_pair()
    model = _fresh(memo_model)
    for _ in range(2):
        model.predict_rank(test, train_interactions=train)
    edit(train)
    with pytest.raises(ValueError, match="share 1 interactions") as want:
        _fresh(memo_model).predict_rank(test, train_interactions=train)
    for counter in ("intersection_misses", "intersection_hits"):
        with observability.recording() as rec, pytest.raises(ValueError) as got:
            model.predict_rank(test, train_interactions=train)
        assert str(got.value) == str(want.value)
        assert rec.counters == {**rec.counters, counter: 1}
        assert "rank_prep_hits" not in rec.counters and "rank_prep_misses" not in rec.counters
    # The staged tiers follow the edit too.
    got = model.predict_rank(test, train_interactions=train, check_intersections=False)
    fresh = _fresh(memo_model).predict_rank(test, train_interactions=train,
                                            check_intersections=False)
    assert got.data.tobytes() == fresh.data.tobytes()


@pytest.mark.parametrize("unchecked", ["check_intersections=False", "no train"])
def test_predict_rank_without_a_check_counts_no_intersections(memo_model, unchecked):
    train, test = _memo_pair()
    model = _fresh(memo_model)
    if unchecked == "no train":
        kwargs = {}
    else:
        kwargs = {"train_interactions": train, "check_intersections": False}
    with observability.recording() as rec:
        for _ in range(2):
            model.predict_rank(test, **kwargs)
    assert not {"intersection_hits", "intersection_misses"} & set(rec.counters)
    assert rec.counters["rank_prep_misses"] == 1 and rec.counters["rank_prep_hits"] == 1


def _set_item_biases(model):
    model.item_biases = np.linspace(-1.0, 1.0, _MEMO_ITEMS, dtype=np.float32)


def _edit_a_view(model):
    model.item_biases[::2] += 1.0  # folded back by the next call


def _fit_partial(model):
    model.fit_partial(_memo_pair()[0], epochs=1)


def _move_device(model):
    model.device = "cpu"


@pytest.mark.parametrize("change,prep", [
    (_set_item_biases, "rank_prep_hits"),
    (_edit_a_view, "rank_prep_hits"),
    (_fit_partial, "rank_prep_hits"),
    (_move_device, "rank_prep_misses"),  # the staged tensors were on the old device
], ids=["set_field", "view_edit", "fit_partial", "device"])
def test_a_state_change_rebuilds_the_catalog_and_keeps_the_staged_inputs(
        memo_model, change, prep):
    train, test = _memo_pair()
    model = _fresh(memo_model)
    model.predict_rank(test, train_interactions=train)
    model.recommend(np.arange(3), k=5)
    assert ("catalog", _MEMO_ITEMS) in model._state_cache
    change(model)
    with observability.recording() as rec:
        got = model.predict_rank(test, train_interactions=train)
    assert rec.counters[prep] == 1 and sum(
        n for c, n in rec.counters.items() if c.startswith("rank_prep_")) == 1
    assert ("catalog", _MEMO_ITEMS) not in model._state_cache
    fresh = _fresh(model)
    want = fresh.predict_rank(test, train_interactions=train)
    assert got.data.tobytes() == want.data.tobytes()
    for a, b in zip(model.recommend(np.arange(3), k=5), fresh.recommend(np.arange(3), k=5)):
        assert np.array_equal(a, b)
