"""The port's ``Dataset`` against ``lightfm_tpu.data.Dataset``.

The same seeded inputs go to both packages; the mappings, shapes and every
built matrix (indices, values, dtype) must be equal, and a bad input must
raise the same ``ValueError`` text.  The 11 cases of ``tests/test_data.py``
run here in both packages, beside array and iterable inputs, weights,
``normalize`` on and off, generators and ``fit_partial`` across the native
and Python paths.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from lightfm_tpu import data as jax_data

from lightfm_tpu_torch import data
from lightfm_tpu_torch.data import Dataset


def _both(*args, **kwargs):
    return Dataset(*args, **kwargs), jax_data.Dataset(*args, **kwargs)


def _same(a, b):
    """Equal sparse matrices in layout, indices, values and dtype."""
    assert type(a) is type(b) and a.shape == b.shape and a.dtype == b.dtype
    names = ("row", "col", "data") if sp.isspmatrix_coo(a) else ("indptr", "indices", "data")
    for name in names:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def _same_state(ds, ref):
    assert ds.mapping() == ref.mapping()
    for name in ("interactions_shape", "user_features_shape", "item_features_shape",
                 "model_dimensions"):
        assert getattr(ds, name)() == getattr(ref, name)()


def _same_error(call_port, call_ref):
    with pytest.raises(ValueError) as got:
        call_port()
    with pytest.raises(ValueError) as want:
        call_ref()
    assert str(got.value) == str(want.value)


# --- the 11 cases of tests/test_data.py, each in both packages ---


def test_fit_shapes():
    ds, ref = _both()
    for d in (ds, ref):
        d.fit(["a", "b", "c"], [1, 2])
    _same_state(ds, ref)
    assert ds.interactions_shape() == (3, 2) and ds.model_dimensions() == (3, 2)


def test_no_identity_features():
    ds, ref = _both(user_identity_features=False, item_identity_features=False)
    for d in (ds, ref):
        d.fit(["a", "b"], [1], user_features=["f1"], item_features=["g1", "g2"])
    _same_state(ds, ref)
    assert ds.user_features_shape() == (2, 1) and ds.item_features_shape() == (1, 2)


def test_build_interactions_and_weights():
    ds, ref = _both()
    rows = [("u1", "i1"), ("u2", "i3", 3.0)]
    for d in (ds, ref):
        d.fit(["u1", "u2"], ["i1", "i2", "i3"])
    for g, w in zip(ds.build_interactions(rows), ref.build_interactions(rows)):
        _same(g, w)
    assert set(ds.build_interactions(rows)[1].data) == {1.0, 3.0}


def test_unknown_ids_raise():
    ds, ref = _both()
    for d in (ds, ref):
        d.fit(["u1"], ["i1"])
    for bad in ([("nope", "i1")], [("u1", "nope")], [("u1",)]):
        _same_error(lambda: ds.build_interactions(bad), lambda: ref.build_interactions(bad))
    for bad in ([("i1", ["unknown_feature"])], [("nope", ["i1"])], [("i1",)]):
        _same_error(lambda: ds.build_item_features(bad), lambda: ref.build_item_features(bad))


def test_feature_builder_identity_plus_features():
    ds, ref = _both()
    rows = [("i1", ["genre:a"]), ("i2", {"genre:b": 3.0})]
    for d in (ds, ref):
        d.fit(["u1"], ["i1", "i2"], item_features=["genre:a", "genre:b"])
    feats = ds.build_item_features(rows, normalize=False)
    _same(feats, ref.build_item_features(rows, normalize=False))
    dense = feats.toarray()
    assert feats.shape == (2, 4) and dense[1, 3] == 3.0 and dense[0, 0] == 1.0


def test_l1_normalization():
    ds, ref = _both()
    for d in (ds, ref):
        d.fit(["u1"], ["i1"], item_features=["f"])
    got = ds.build_item_features([("i1", {"f": 3.0})], normalize=True)
    _same(got, ref.build_item_features([("i1", {"f": 3.0})], normalize=True))
    assert np.allclose(np.asarray(got.sum(axis=1)).ravel(), 1.0)
    ds2, ref2 = _both(item_identity_features=False)
    for d in (ds2, ref2):
        d.fit(["u1"], ["i1", "i2"], item_features=["f"])
    _same_error(lambda: ds2.build_item_features([("i1", {"f": 1.0})], normalize=True),
                lambda: ref2.build_item_features([("i1", {"f": 1.0})], normalize=True))


def test_fit_partial_extends_mappings():
    ds, ref = _both()
    for d in (ds, ref):
        d.fit(["u1"], ["i1"])
        d.fit_partial(users=["u2"], items=["i2"])
    _same_state(ds, ref)
    for d in (ds, ref):
        d.fit(["x"], ["y"])
    _same_state(ds, ref)
    assert ds.interactions_shape() == (1, 1)


def test_mapping_roundtrip():
    ds, ref = _both()
    for d in (ds, ref):
        d.fit(["u1", "u2"], ["i1"])
    assert ds.mapping() == ref.mapping() == ({"u1": 0, "u2": 1}, {"u1": 0, "u2": 1},
                                             {"i1": 0}, {"i1": 0})


def test_interactions_out_of_bounds_raise():
    m = data._IncrementalCOOMatrix((2, 2), np.float32)
    for i, j in ((2, 0), (0, 2)):
        with pytest.raises(Exception, match="Index out of bounds"):
            m.append(i, j, 1.0)
    with pytest.raises(Exception, match="Dtype not supported"):
        data._IncrementalCOOMatrix((2, 2), np.int16)
    m.append(1, 1, 2.5)
    ref = jax_data._IncrementalCOOMatrix((2, 2), np.float32)
    ref.append(1, 1, 2.5)
    _same(m.tocoo(), ref.tocoo())
    assert len(m) == 1


def test_end_to_end_with_model():
    from lightfm_tpu_torch import LightFM

    ds, ref = _both()
    users = ["u%d" % i for i in range(30)]
    items = ["i%d" % i for i in range(20)]
    rng = np.random.RandomState(0)
    pairs = [(users[rng.randint(30)], items[rng.randint(20)]) for _ in range(100)]
    built = []
    for d in (ds, ref):
        d.fit(users, items, item_features=["f1", "f2"])
        inter, weights = d.build_interactions(pairs)
        feats = d.build_item_features(
            ((i, ["f1"] if idx % 2 else ["f2"]) for idx, i in enumerate(items)))
        built.append((inter, weights, feats))
    for g, w in zip(*built):
        _same(g, w)
    inter, weights, feats = built[0]
    model = LightFM(random_state=1, device="cpu")
    model.fit(inter, item_features=feats, sample_weight=weights, epochs=2)
    assert model.item_embeddings.shape[0] == ds.model_dimensions()[1]
    assert np.isfinite(model.predict(np.arange(5), np.arange(5), item_features=feats)).all()


def test_fit_accepts_generators():
    ds, ref = _both()
    for d in (ds, ref):
        d.fit((u for u in ["a", "b"]), (i for i in ["x", "y", "z"]))
    _same_state(ds, ref)
    assert ds.user_features_shape() == (2, 2) and ds.item_features_shape() == (3, 3)


# --- array and iterable inputs, weights, normalize, mixed paths ---


def _seeded_log(seed, n=400, n_users=60, n_items=90, n_tags=15):
    rng = np.random.RandomState(seed)
    users = 10**9 + 17 * rng.randint(0, n_users, n)
    items = -(10**6) - 3 * rng.randint(0, n_items, n)
    weights = rng.rand(n).astype(np.float32)
    item_ids = np.unique(items)
    tags = 5000 + rng.permutation(n_tags)
    e = np.repeat(item_ids, 3)
    f = tags[rng.randint(0, n_tags, e.size)]
    fw = (rng.rand(e.size) + 0.1).astype(np.float32)
    return users, items, weights, tags, e, f, fw


@pytest.mark.parametrize("identity", [True, False])
@pytest.mark.parametrize("form", ["arrays", "iterables", "generators"])
def test_every_matrix_equals_the_jax_dataset(form, identity):
    users, items, weights, tags, e, f, fw = _seeded_log(3)

    def shaped(*cols):
        if form == "arrays":
            return tuple(cols)
        rows = list(zip(*(c.tolist() for c in cols)))
        return rows if form == "iterables" else (r for r in rows)

    def fit_args():
        if form == "arrays":
            return users, items, tags
        if form == "iterables":
            return users.tolist(), items.tolist(), tags.tolist()
        return (u for u in users.tolist()), (i for i in items.tolist()), (t for t in tags.tolist())

    ds, ref = _both(user_identity_features=identity, item_identity_features=identity)
    for d in (ds, ref):
        u, i, t = fit_args()
        d.fit(u, i, item_features=t)
    _same_state(ds, ref)
    for data_cols in ((users, items), (users, items, weights)):
        for g, w in zip(ds.build_interactions(shaped(*data_cols)),
                        ref.build_interactions(shaped(*data_cols))):
            _same(g, w)
    for norm in (False, True):
        if form == "arrays":
            cases = [(e, f), (e, f, fw)]
        else:
            cases = [[(a, [b]) for a, b in zip(e.tolist(), f.tolist())],
                     [(a, {b: c}) for a, b, c in zip(e.tolist(), f.tolist(), fw.tolist())]]
        for case in cases:
            got = ds.build_item_features(case, normalize=norm)
            _same(got, ref.build_item_features(case, normalize=norm))
            if norm:
                np.testing.assert_allclose(np.asarray(got.sum(axis=1)).ravel(), 1.0, atol=1e-6)


def test_array_errors_carry_the_jax_text():
    users, items, weights, tags, e, f, fw = _seeded_log(5)
    ds, ref = _both()
    for d in (ds, ref):
        d.fit(users, items, item_features=tags)
    for bad in ((np.array([7]), items[:1]), (users[:1], np.array([7])),
                (np.concatenate([users[:3], [11]]), items[:4])):
        _same_error(lambda: ds.build_interactions(bad), lambda: ref.build_interactions(bad))
    for bad in ((np.array([7]), tags[:1]), (e[:1], np.array([7]))):
        _same_error(lambda: ds.build_item_features(bad), lambda: ref.build_item_features(bad))
    _same_error(lambda: ds.build_interactions([("a", "b", 1.0, 2)]),
                lambda: ref.build_interactions([("a", "b", 1.0, 2)]))
    for cls in (Dataset, jax_data.Dataset):
        with pytest.raises(ValueError, match="You must call fit first"):
            cls()._check_fitted()


def test_fit_partial_across_native_and_python_paths():
    users, items, weights, tags, e, f, fw = _seeded_log(6)
    ds, ref = _both()
    steps = [
        lambda: dict(users=users[:100], items=items[:100]),          # native
        lambda: dict(users=["alice", "bob"], items=["thing"]),       # Python (strings)
        lambda: dict(users=users[100:], items=items[100:]),          # mixed keys: Python
        lambda: dict(item_features=tags),                            # mixed keys: Python
        lambda: dict(users=np.array([2**63 + 5], dtype=np.uint64)),  # above int64: Python
        lambda: dict(users=(u for u in [1, 2, 1])),                  # a generator
    ]
    for step in steps:
        for d in (ds, ref):
            d.fit_partial(**step())
        _same_state(ds, ref)
    rows = [(int(u), int(i)) for u, i in zip(users[:50], items[:50])] + [("alice", "thing")]
    for g, w in zip(ds.build_interactions(rows), ref.build_interactions(rows)):
        _same(g, w)
    # Mapping keys that are not all ints reroute array inputs through Python.
    for g, w in zip(ds.build_interactions((users[:50], items[:50])),
                    ref.build_interactions((users[:50], items[:50]))):
        _same(g, w)
    _same(ds.build_item_features((e, f), normalize=False),
          ref.build_item_features((e, f), normalize=False))


def test_uint64_and_int32_arrays():
    ids32 = np.array([5, 3, 5, 9], dtype=np.int32)
    idsu = np.array([5, 2**64 - 1, 5, 2**63], dtype=np.uint64)
    ds, ref = _both()
    for d in (ds, ref):
        d.fit(ids32, idsu)
    _same_state(ds, ref)
    for g, w in zip(ds.build_interactions((ids32, idsu[[0, 1, 3, 0]])),
                    ref.build_interactions((ids32, idsu[[0, 1, 3, 0]]))):
        _same(g, w)
