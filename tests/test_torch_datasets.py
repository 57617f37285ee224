"""The port's dataset fetchers and synthetic generator against the JAX
package's: ``generate_synthetic`` bitwise equal for the same seed, and the
MovieLens and StackExchange fetchers, run on archives built in
``tmp_path`` (nothing downloads), giving equal outputs in both packages,
with the MovieLens parse on the native engine and on the Python path."""

import zipfile

import numpy as np
import pytest
import scipy.sparse as sp

from lightfm_tpu import datasets as jax_datasets

from lightfm_tpu_torch import datasets, native
from lightfm_tpu_torch.datasets import _common


def _same(a, b):
    if sp.issparse(a):
        assert type(a) is type(b) and a.shape == b.shape and a.dtype == b.dtype
        a, b = a.tocoo(), b.tocoo()
        for name in ("row", "col", "data"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _same_dict(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        _same(got[key], want[key])


@pytest.mark.parametrize("kwargs", [
    dict(n_users=100, n_items=80, seed=1),
    dict(n_users=150, n_items=120, rank=4, interactions_per_user=40, test_per_user=3,
         noise=0.5, popularity_skew=0.3, seed=7, user_block=64),
])
def test_generate_synthetic_bitwise_equal(kwargs):
    _same_dict(datasets.generate_synthetic(**kwargs), jax_datasets.generate_synthetic(**kwargs))


def _make_ml100k_zip(path, n_users=20, n_items=15, n_genres=3, seed=0):
    """A miniature ml-100k-format zip (the layout ``fetch_movielens`` reads)."""
    rng = np.random.RandomState(seed)
    base, test = [], []
    for u in range(1, n_users + 1):
        items = rng.choice(n_items, 6, replace=False) + 1
        base += [f"{u}\t{i}\t{rng.randint(1, 6)}\t874965758" for i in items[:4]]
        test += [f"{u}\t{i}\t{rng.randint(1, 6)}\t874965758" for i in items[4:]]
    genres = [f"genre{g}|{g}" for g in range(n_genres)]
    item_lines = [
        f"{i}|Movie {i}|01-Jan-1995||http://example.com|"
        + "|".join(str(int(rng.rand() < 0.4)) for _ in range(n_genres))
        for i in range(1, n_items + 1)
    ]
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-100k/ua.base", "\n".join(base) + "\n")
        z.writestr("ml-100k/ua.test", "\n".join(test) + "\n")
        z.writestr("ml-100k/u.item", "\n".join(item_lines) + "\n")
        z.writestr("ml-100k/u.genre", "\n".join(genres) + "\n")


ML_OPTIONS = [dict(), dict(genre_features=True), dict(indicator_features=False, genre_features=True),
              dict(min_rating=4.0)]


@pytest.mark.parametrize("options", ML_OPTIONS, ids=["indicator", "both", "genres", "min_rating"])
def test_fetch_movielens_equals_jax(tmp_path, monkeypatch, options):
    (tmp_path / "movielens100k").mkdir()
    _make_ml100k_zip(str(tmp_path / "movielens100k" / "movielens.zip"))
    kw = dict(data_home=str(tmp_path), download_if_missing=False, **options)
    want = jax_datasets.fetch_movielens(**kw)
    got = datasets.fetch_movielens(**kw)
    _same_dict(got, want)
    assert got["train"].shape == (20, 15) and got["train"].multiply(got["test"]).nnz == 0
    # The Python parse (a machine without g++) gives the same arrays.
    monkeypatch.setattr(native, "available", lambda: False)
    assert native.AVAILABLE is False
    _same_dict(datasets.fetch_movielens(**kw), want)


def test_fetch_movielens_errors(tmp_path):
    with pytest.raises(IOError):
        datasets.fetch_movielens(data_home=str(tmp_path), download_if_missing=False)
    with pytest.raises(ValueError, match="At least one"):
        datasets.fetch_movielens(data_home=str(tmp_path), indicator_features=False)
    (tmp_path / "movielens100k").mkdir(exist_ok=True)
    bad = tmp_path / "movielens100k" / "movielens.zip"
    bad.write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="Corrupted Movielens download"):
        datasets.fetch_movielens(data_home=str(tmp_path), download_if_missing=False)
    assert not bad.exists()


def _make_stackexchange_npz(root, seed=0, n_users=30, n_items=40, nnz=200):
    rng = np.random.RandomState(seed)
    flat = rng.choice(n_users * n_items, nnz, replace=False)
    cache = root / "stackexchange" / "crossvalidated"
    cache.mkdir(parents=True)
    np.savez(
        str(cache / "data.npz"),
        interactions_data=rng.randint(1, 10**6, nnz).astype(np.float64),
        interactions_row=flat // n_items,
        interactions_col=flat % n_items,
        interactions_shape=np.array([n_users, n_items]),
        features_data=np.ones(60, np.float32),
        features_row=rng.randint(0, n_items, 60),
        features_col=rng.randint(0, 8, 60),
        features_shape=np.array([n_items, 8]),
        labels=np.array([f"tag{i}" for i in range(8)]),
    )


@pytest.mark.parametrize("options", [
    dict(tag_features=True, min_training_interactions=0),
    dict(min_training_interactions=2, test_set_fraction=0.3),
    dict(indicator_features=False, tag_features=True, min_training_interactions=1),
], ids=["tags", "filtered", "tags-only"])
def test_fetch_stackexchange_equals_jax(tmp_path, options):
    _make_stackexchange_npz(tmp_path)
    kw = dict(data_home=str(tmp_path), download_if_missing=False, **options)
    got = datasets.fetch_stackexchange("crossvalidated", **kw)
    _same_dict(got, jax_datasets.fetch_stackexchange("crossvalidated", **kw))
    assert got["train"].multiply(got["test"]).nnz == 0


def test_fetch_stackexchange_errors(tmp_path):
    for kw, msg in ((dict(indicator_features=False), "At least one"),
                    (dict(test_set_fraction=1.0), "between 0 and 1")):
        with pytest.raises(ValueError, match=msg):
            datasets.fetch_stackexchange("crossvalidated", data_home=str(tmp_path), **kw)
    with pytest.raises(ValueError, match="Unknown dataset"):
        datasets.fetch_stackexchange("nope", data_home=str(tmp_path))
    with pytest.raises(IOError):
        datasets.fetch_stackexchange("crossvalidated", data_home=str(tmp_path),
                                     download_if_missing=False)


def test_cache_layout_and_download_are_atomic(tmp_path, monkeypatch):
    # get_data names the same cached file as the JAX package's and downloads
    # only on a miss, through a .part file renamed into place.
    fetched = []

    class _Resp:
        def __init__(self):
            self.chunks = [b"abc", b"def", b""]

        def read(self, n):
            return self.chunks.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def urlopen(url):
        fetched.append(url)
        return _Resp()

    monkeypatch.setattr(_common.urllib.request, "urlopen", urlopen)
    path = _common.get_data(str(tmp_path), "http://example.invalid/x.zip", "sub", "x.zip", True)
    assert path == str((tmp_path / "sub" / "x.zip").resolve())
    assert (tmp_path / "sub" / "x.zip").read_bytes() == b"abcdef"
    assert not (tmp_path / "sub" / "x.zip.part").exists()
    assert _common.get_data(str(tmp_path), "http://example.invalid/x.zip", "sub", "x.zip", True) == path
    assert fetched == ["http://example.invalid/x.zip"]
