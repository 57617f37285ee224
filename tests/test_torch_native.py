"""The port's native ingest engine against ``lightfm_tpu.native``.

- ``map_ids``, ``lookup_ids`` and ``parse_interactions`` give the JAX
  package's outputs, element for element, on seeded random and edge
  inputs (empty inputs, negative ids, malformed lines, a trailing
  delimiter).
- The port's ``Dataset`` keeps the 11 native-path behaviours of
  ``tests/test_native.py`` and gives the JAX ``Dataset``'s mappings and
  matrices on them.
- The loader's build: the library's name is a hash of the source and the
  flags, a build writes a temporary file and renames it into place, an
  existing library is reused, a failed build raises with the compiler's
  output, and only a machine without ``g++`` reports the engine missing.
  These run against a stand-in compiler, so no test builds twice.
- ``INT64_MIN``, the engine's empty-slot marker: the port's loader refuses
  it, and the port's ``Dataset`` maps it as the JAX package's pure-Python
  path does (the JAX native path maps it anew on every occurrence).
"""

import hashlib
import subprocess

import numpy as np
import pytest
import scipy.sparse as sp

from lightfm_tpu import native as jax_native
from lightfm_tpu.data import Dataset as JaxDataset

from lightfm_tpu_torch import native
from lightfm_tpu_torch.data import Dataset

MIN = np.iinfo(np.int64).min


def _assert_same_coo(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.row, b.row)
    np.testing.assert_array_equal(a.col, b.col)
    np.testing.assert_array_equal(a.data, b.data)


def _assert_same_csr(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_engine_is_built_here():
    # Both hosts this package runs on have g++: the native path is taken.
    assert native.AVAILABLE and jax_native.AVAILABLE
    assert native.target().exists()


CASES = ["empty", "empty-ids", "small", "negative", "wide", "repeats"]


@pytest.mark.parametrize("case", CASES)
def test_map_and_lookup_equal_the_jax_engine(case):
    rng = np.random.RandomState(CASES.index(case))
    existing, ids = {
        "empty": (np.empty(0, np.int64), np.empty(0, np.int64)),
        "empty-ids": (np.array([3, 1, 2], np.int64), np.empty(0, np.int64)),
        "small": (np.empty(0, np.int64), rng.randint(0, 50, 500)),
        "negative": (np.array([-7, 0, 7], np.int64), rng.randint(-100, 100, 2000)),
        "wide": (rng.randint(-2**62, 2**62, 40, dtype=np.int64),
                 rng.randint(-2**62, 2**62, 3000, dtype=np.int64)),
        "repeats": (np.empty(0, np.int64), np.repeat(rng.randint(0, 5000, 700), 9)),
    }[case]
    new = native.map_ids(existing, ids)
    np.testing.assert_array_equal(new, jax_native.map_ids(existing, ids))
    assert new.dtype == np.int64
    keys = np.concatenate([existing, new])
    probe = np.concatenate([ids, rng.randint(-2**62, 2**62, 50, dtype=np.int64)])
    got = native.lookup_ids(keys, probe)
    np.testing.assert_array_equal(got, jax_native.lookup_ids(keys, probe))
    assert got.dtype == np.int32


@pytest.mark.parametrize("text", [
    b"",
    b"1\t10\t4.0\n2\t20\nbad line\n3\t30\t2.5\n",
    b"1\t2\t\n3\t4\t5\n",  # a trailing delimiter keeps the next line's uid
    b"-5\t-6\t-1.5\n\n\t\n7\t\n8\t9\tx\n10\t11",  # negatives, blanks, no final newline
    b"1 2 3\n4 5\n",
])
def test_parse_equals_the_jax_engine(text):
    delim = b" " if text.startswith(b"1 2") else b"\t"
    got = native.parse_interactions(text, delim=delim)
    want = jax_native.parse_interactions(text, delim=delim)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_parse_random_lines_equal_the_jax_engine():
    rng = np.random.RandomState(4)
    lines = [f"{u}\t{i}\t{v:.3f}\t874965758" for u, i, v in
             zip(rng.randint(1, 944, 3000), rng.randint(1, 1683, 3000), rng.rand(3000) * 5)]
    buf = "\n".join(lines).encode()
    for g, w in zip(native.parse_interactions(buf), jax_native.parse_interactions(buf)):
        np.testing.assert_array_equal(g, w)


# --- the 11 native-path cases of tests/test_native.py, in both packages ---


def test_map_ids_first_seen_order():
    ids = np.array([5, 3, 5, 9, 3, 7], dtype=np.int64)
    uniq = native.map_ids(np.empty(0, np.int64), ids)
    assert uniq.tolist() == [5, 3, 9, 7]
    assert native.map_ids(uniq, np.array([9, 1, 5, 2], dtype=np.int64)).tolist() == [1, 2]


def test_lookup_ids_missing_is_minus_one():
    keys = np.array([5, 3, 9], dtype=np.int64)
    assert native.lookup_ids(keys, np.array([3, 42, 9], dtype=np.int64)).tolist() == [1, -1, 2]


def test_parse_interactions():
    u, i, v = native.parse_interactions(b"1\t10\t4.0\n2\t20\nbad line\n3\t30\t2.5\n")
    assert u.tolist() == [1, 2, 3] and i.tolist() == [10, 20, 30]
    assert v.tolist() == [4.0, 1.0, 2.5]


def test_dataset_fast_fit_matches_python_and_jax():
    rng = np.random.RandomState(0)
    users, items = rng.randint(0, 50, 500), rng.randint(100, 180, 500)
    fast = Dataset()
    fast.fit(users, items)
    slow = Dataset()
    slow.fit([int(u) for u in users], [int(i) for i in items])
    ref = JaxDataset()
    ref.fit(users, items)
    assert fast.mapping() == slow.mapping() == ref.mapping()


def test_dataset_fast_build_interactions_matches_python_and_jax():
    rng = np.random.RandomState(1)
    users, items = rng.randint(0, 50, 300), rng.randint(0, 80, 300)
    weights = rng.rand(300).astype(np.float32)
    ds, ref = Dataset(), JaxDataset()
    ds.fit(users, items)
    ref.fit(users, items)
    fast = ds.build_interactions((users, items, weights))
    slow = ds.build_interactions(
        [(int(u), int(i), float(w)) for u, i, w in zip(users, items, weights)])
    for f, s, r in zip(fast, slow, ref.build_interactions((users, items, weights))):
        _assert_same_coo(f, r)
        assert (sp.csr_matrix(f) != sp.csr_matrix(s)).nnz == 0


def test_dataset_fast_build_unknown_id_raises():
    for cls in (Dataset, JaxDataset):
        ds = cls()
        ds.fit(np.arange(10), np.arange(10))
        with pytest.raises(ValueError, match="User id 99 not in user id mapping"):
            ds.build_interactions((np.array([99]), np.array([1])))
        with pytest.raises(ValueError, match="Item id 99 not in item id mapping"):
            ds.build_interactions((np.array([1]), np.array([99])))


def test_fit_partial_mixed_paths():
    maps = []
    for cls in (Dataset, JaxDataset):
        ds = cls()
        ds.fit_partial(users=np.array([7, 8], dtype=np.int64), items=np.array([1]))
        ds.fit_partial(users=["alice"], items=["thing"])
        maps.append(ds.mapping())
    assert maps[0] == maps[1]
    assert maps[0][0] == {7: 0, 8: 1, "alice": 2}


def test_feature_builder_arrays_match_python_and_jax():
    rng = np.random.RandomState(2)
    items, feats = np.arange(40), np.arange(100, 112)
    ds, ref = Dataset(), JaxDataset()
    for d in (ds, ref):
        d.fit(np.arange(5), items, item_features=feats)
    e = rng.randint(0, 40, 120)
    f = feats[rng.randint(0, len(feats), 120)]
    w = rng.rand(120).astype(np.float32)
    for data, norm in (((e, f, w), True), ((e, f), False), ((e, f, w), False), ((e, f), True)):
        _assert_same_csr(ds.build_item_features(data, normalize=norm),
                         ref.build_item_features(data, normalize=norm))
    fast = ds.build_item_features((e, f, w), normalize=True)
    slow = ds.build_item_features(
        [(int(a), {int(b): float(c)}) for a, b, c in zip(e, f, w)], normalize=True)
    np.testing.assert_allclose(fast.toarray(), slow.toarray(), atol=1e-6)


def test_feature_builder_arrays_unknown_raises():
    for cls in (Dataset, JaxDataset):
        ds = cls()
        ds.fit(np.arange(5), np.arange(10), item_features=np.arange(100, 105))
        with pytest.raises(ValueError, match="item id 99 not in item id mappings"):
            ds.build_item_features((np.array([99]), np.array([100])))
        with pytest.raises(ValueError, match="Feature 999 not in feature mapping"):
            ds.build_item_features((np.array([1]), np.array([999])))


def test_fit_partial_mixed_feature_mapping_keeps_identity_entries():
    maps = []
    for cls in (Dataset, JaxDataset):
        ds = cls()
        ds.fit_partial(item_features=["tag:a"])
        ds.fit_partial(items=np.array([5, 6], np.int64))
        maps.append(ds.mapping())
    assert maps[0] == maps[1]
    assert maps[0][3] == {"tag:a": 0, 5: 1, 6: 2}


def test_parse_trailing_delimiter_does_not_consume_next_line():
    uids, iids, vals = native.parse_interactions(b"1\t2\t\n3\t4\t5\n")
    assert uids.tolist() == [1, 3] and iids.tolist() == [2, 4] and vals.tolist() == [1.0, 5.0]


# --- the build ---


def test_library_name_is_a_hash_of_source_and_flags(monkeypatch):
    digest = hashlib.sha256(native.SRC.read_bytes())
    digest.update(" ".join(native.CXX_FLAGS).encode())
    assert native.target().name == f"ingest_{digest.hexdigest()[:16]}.so"
    assert native.target().parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build" and native.BUILD_DIR.parent.name == "lightfm_tpu_torch"
    before = native.target()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.target() != before


class _FakeCompiler:
    """Stands in for ``subprocess.run``: writes the ``-o`` path (or fails)."""

    def __init__(self, returncode=0):
        self.calls = []
        self.returncode = returncode

    def __call__(self, cmd, **kwargs):
        self.calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        if self.returncode == 0:
            with open(out, "wb") as fh:
                fh.write(b"built")
        return subprocess.CompletedProcess(cmd, self.returncode, stdout="",
                                           stderr="ingest.cpp:1: error: stand-in")


def test_build_renames_a_temporary_file_and_reuses_it(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    fake = _FakeCompiler()
    monkeypatch.setattr(native.subprocess, "run", fake)
    out = native.build()
    assert out == native.target() and out.read_bytes() == b"built"
    (cmd,) = fake.calls
    written = cmd[cmd.index("-o") + 1]
    assert written != str(out) and written.endswith(".tmp")
    assert tmp_path.joinpath("_build") == out.parent
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]  # no temporary left
    assert list(native.CXX_FLAGS) == cmd[1:1 + len(native.CXX_FLAGS)]
    assert native.build() == out and len(fake.calls) == 1  # reused, not rebuilt


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native.subprocess, "run", _FakeCompiler(returncode=1))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="error: stand-in"):
        native.AVAILABLE
    assert list((tmp_path / "_build").iterdir()) == []


def test_without_gxx_the_engine_is_missing_and_python_paths_run(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.AVAILABLE is False
    ds, ref = Dataset(), JaxDataset()
    for d in (ds, ref):
        d.fit(np.array([4, 2, 4]), np.array([9, 8]))
    assert ds.mapping() == ref.mapping()
    _assert_same_coo(ds.build_interactions((np.array([2, 4]), np.array([8, 9])))[0],
                     ref.build_interactions([(2, 8), (4, 9)])[0])


# --- INT64_MIN ---


def test_loader_refuses_the_empty_slot_marker():
    with pytest.raises(ValueError, match="INT64_MIN"):
        native.map_ids(np.empty(0, np.int64), np.array([MIN, 5]))
    with pytest.raises(ValueError, match="INT64_MIN"):
        native.lookup_ids(np.array([MIN]), np.array([5]))
    # The JAX engine takes it and inserts it again on every occurrence.
    assert jax_native.map_ids(np.empty(0, np.int64), np.array([MIN, MIN, 5])).tolist() == [MIN, MIN, 5]


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_dataset_maps_int64_min_as_the_python_path(dtype):
    rng = np.random.RandomState(9)
    users = rng.randint(-3, 3, 40).astype(np.int64)
    users[[0, 7, 19]] = MIN
    items = rng.randint(0, 6, 40).astype(dtype)
    weights = rng.rand(40).astype(np.float32)
    feats = np.array([MIN, 11, 12], dtype=np.int64)

    ds = Dataset()
    ds.fit(users, items, user_features=feats)
    ref = JaxDataset()  # the reference's pure-Python path: lists of Python ints
    ref.fit(users.tolist(), items.tolist(), user_features=feats.tolist())
    assert ds.mapping() == ref.mapping()
    assert ds.mapping()[0][MIN] == 0 and ds.interactions_shape() == ref.interactions_shape()

    got = ds.build_interactions((users, items, weights))
    want = ref.build_interactions(zip(users.tolist(), items.tolist(), weights.tolist()))
    for g, w in zip(got, want):
        _assert_same_coo(g, w)
    e = users[:10]
    f = feats[rng.randint(0, 3, 10)]
    _assert_same_csr(ds.build_user_features((e, f), normalize=False),
                     ref.build_user_features([(a, [b]) for a, b in zip(e.tolist(), f.tolist())],
                                             normalize=False))
    # A later native-shaped call on a mapping that holds the marker stays exact.
    ds.fit_partial(users=np.array([MIN, 100], np.int64))
    ref.fit_partial(users=[MIN, 100])
    assert ds.mapping() == ref.mapping()
    with pytest.raises(ValueError, match="User id 101 not in user id mapping"):
        ds.build_interactions((np.array([MIN, 101]), np.array([0, 0], dtype=dtype)))
