"""lightfm_tpu_torch.sparse vs lightfm_tpu.sparse, on the CPU: the padded
arrays must be identical."""

import numpy as np
import pytest
import scipy.sparse as sp

from lightfm_tpu import sparse as jax_sparse

from lightfm_tpu_torch import sparse


def _skewed_csr(seed=0, n_rows=40, n_cols=30, heavy=(3, 17)):
    rng = np.random.RandomState(seed)
    m = sp.random(n_rows, n_cols, density=0.1, random_state=rng, format="lil",
                  dtype=np.float32)
    for r in heavy:  # rows far wider than the rest spill into overflow chunks
        m[r, :] = rng.rand(n_cols).astype(np.float32) + 0.1
    m[5, :] = 0  # an empty row
    return m.tocsr()


def _assert_same_padded(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.n_rows == want.n_rows and got.n_cols == want.n_cols
    assert got.max_nnz == want.max_nnz
    if isinstance(got, sparse.ChunkedRows):
        _assert_same_padded(got.base, want.base)
        for a in ("over_slot", "over_idx", "over_wts"):
            assert np.array_equal(getattr(got, a).numpy(), np.asarray(getattr(want, a))), a
        assert got.n_chunks == want.n_chunks
    else:
        assert np.array_equal(got.idx.numpy(), np.asarray(want.idx))
        assert np.array_equal(got.wts.numpy(), np.asarray(want.wts))


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"pad_multiple": 8},
        {"pad_multiple": 8, "min_width": 12},
        {"width_cap": 4, "chunk_width": 8},
        {"width_cap": 5, "pad_multiple": 8, "chunk_width": 4},
        {"width_cap": 100},  # cap above every row: stays dense
    ],
)
def test_pad_csr_matches_jax(kwargs):
    csr = _skewed_csr()
    got = sparse.pad_csr(csr, **kwargs)
    want = jax_sparse.pad_csr(csr, **kwargs)
    _assert_same_padded(got, want)
    assert got.n_rows == 40 and got.n_cols == 30


@pytest.mark.parametrize("kwargs", [{}, {"width_cap": 4, "chunk_width": 8}])
def test_trim_rows_matches_jax(kwargs):
    csr = _skewed_csr(seed=1)
    got = sparse.trim_rows(sparse.pad_csr(csr, **kwargs), 20)
    want = jax_sparse.trim_rows(jax_sparse.pad_csr(csr, **kwargs), 20)
    _assert_same_padded(got, want)


def test_identity_rows():
    rows = sparse.identity_rows(7)
    want = jax_sparse.identity_rows(7)
    assert (rows.n_rows, rows.n_cols, rows.max_nnz) == (want.n_rows, want.n_cols, want.max_nnz)
    assert sparse.trim_rows(rows, 3).n_rows == jax_sparse.trim_rows(want, 3).n_rows == 3


def test_content_fingerprint_matches_jax_and_sees_swaps():
    csr = _skewed_csr(seed=2)
    assert sparse.content_fingerprint(csr) == jax_sparse.content_fingerprint(csr)
    swapped = csr.copy()
    swapped.data[[0, 1]] = swapped.data[[1, 0]]
    assert sparse.content_fingerprint(swapped) != sparse.content_fingerprint(csr)
    coo = csr.tocoo()
    assert sparse.content_fingerprint(coo) == jax_sparse.content_fingerprint(coo)


@pytest.mark.parametrize(
    "kwargs", [{}, {"pad_multiple": 8}, {"max_width": 3}, {"max_width": 5, "pad_multiple": 4}]
)
def test_pad_csr_sorted_matches_jax(kwargs):
    csr = _skewed_csr(seed=3)
    csr = csr[:, ::-1].tocsr()  # unsorted column order within rows
    got = sparse.pad_csr_sorted(csr, **kwargs)
    want = jax_sparse.pad_csr_sorted(csr, **kwargs)
    assert np.array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert np.array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.n_cols == want.n_cols and got.n_rows == want.n_rows


def test_in_positives_match_jax():
    import torch

    csr = _skewed_csr(seed=4)
    rows_t = sparse.pad_csr_sorted(csr, pad_multiple=8)
    rows_j = jax_sparse.pad_csr_sorted(csr, pad_multiple=8)
    rng = np.random.RandomState(5)
    row_ids = rng.randint(0, 40, 64).astype(np.int32)
    for shape in ((64,), (64, 6)):
        cols = rng.randint(0, 31, shape).astype(np.int32)  # 30 is the sentinel
        got = sparse.in_positives(rows_t, torch.tensor(row_ids), torch.tensor(cols))
        want = jax_sparse.in_positives(rows_j, row_ids, cols)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), np.asarray(want))
    slots = rng.randint(0, 30, (6, 64)).astype(np.int32)
    got = sparse.in_positives_slots(rows_t, torch.tensor(row_ids), torch.tensor(slots))
    want = jax_sparse.in_positives_slots(rows_j, row_ids, slots)
    assert np.array_equal(got.numpy(), np.asarray(want))
    dense = csr.toarray() != 0
    assert np.array_equal(got.numpy(), dense[row_ids[None, :], slots])
