"""The port's ``random_train_test_split`` against the JAX package's: the same
seed (an int or a ``RandomState``) gives bitwise the same split, on COO,
CSR and weight matrices, and the checks of
``tests/test_cross_validation.py`` hold."""

import numpy as np
import pytest
import scipy.sparse as sp

from lightfm_tpu.cross_validation import random_train_test_split as jax_split

from lightfm_tpu_torch.cross_validation import random_train_test_split


def _interactions(n=1000, shape=(100, 80), seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, shape[0], n)
    cols = rng.randint(0, shape[1], n)
    mat = sp.coo_matrix(((rng.rand(n) * 5).astype(dtype), (rows, cols)), shape=shape)
    mat.sum_duplicates()
    return mat


def _same(a, b):
    assert sp.isspmatrix_coo(a) and sp.isspmatrix_coo(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    for name in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("fmt", ["coo", "csr"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("test_percentage", [0.0, 0.2, 0.35, 1.0])
def test_split_bitwise_equal_to_jax(fmt, dtype, test_percentage):
    mat = _interactions(dtype=dtype).asformat(fmt)
    for seed in (0, 7):
        got = random_train_test_split(mat, test_percentage=test_percentage, random_state=seed)
        want = jax_split(mat, test_percentage=test_percentage, random_state=seed)
        for g, w in zip(got, want):
            _same(g, w)


def test_random_state_object_and_weights_split_alike():
    mat = _interactions(seed=3)
    weights = mat.copy()
    weights.data = np.arange(mat.nnz, dtype=np.float32)
    a, b = np.random.RandomState(11), np.random.RandomState(11)
    for g, w in zip(random_train_test_split(mat, random_state=a), jax_split(mat, random_state=b)):
        _same(g, w)
    assert a.randint(10**9) == b.randint(10**9)  # both generators advanced alike
    train, test = random_train_test_split(mat, random_state=4)
    wtrain, wtest = random_train_test_split(weights, random_state=4)
    np.testing.assert_array_equal(train.row, wtrain.row)
    np.testing.assert_array_equal(test.col, wtest.col)


def test_split_fractions_disjoint_and_reproducible():
    mat = _interactions()
    train, test = random_train_test_split(mat, test_percentage=0.2, random_state=0)
    assert train.nnz == int(0.8 * mat.nnz) and train.nnz + test.nnz == mat.nnz
    assert train.multiply(test).nnz == 0
    again, _ = random_train_test_split(mat, test_percentage=0.2, random_state=0)
    assert (train != again).nnz == 0


def test_split_rejects_dense():
    for split in (random_train_test_split, jax_split):
        with pytest.raises(ValueError, match="scipy.sparse"):
            split(np.ones((3, 3)))
