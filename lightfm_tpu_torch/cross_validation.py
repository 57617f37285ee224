"""Dataset splitting utilities.

Counterpart of ``lightfm_tpu/cross_validation.py``: the same ``RandomState``
permutation, so the same seed gives the same split in both packages.

Behavioral parity target: ``lightfm/cross_validation.py:18-80`` in the
reference — a random, disjoint train/test partition of a COO interaction
matrix, seedable so a sample-weight matrix can be split along identical
lines by reusing the seed.  The implementation here is a fresh one built
on a single index permutation rather than the reference's triple-array
shuffle helper.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["random_train_test_split"]


def _as_random_state(random_state) -> np.random.RandomState:
    if isinstance(random_state, np.random.RandomState):
        return random_state
    return np.random.RandomState(seed=random_state)


def random_train_test_split(
    interactions: sp.spmatrix,
    test_percentage: float = 0.2,
    random_state=None,
):
    """Randomly partition ``interactions`` into disjoint train/test halves.

    No effort is made to guarantee every user/item in the test half also
    appears in the train half, so a partial cold-start test set is possible
    (same caveat as the reference).  Pass the same ``random_state`` seed to
    split a parallel sample-weight matrix identically.

    Parameters
    ----------
    interactions : scipy.sparse matrix
        Interactions to split (any sparse format; converted to COO).
    test_percentage : float, optional
        Fraction of interactions assigned to the test set.
    random_state : int or numpy.random.RandomState, optional
        Seed (or generator) controlling the permutation.

    Returns
    -------
    (train, test) : pair of scipy.sparse.coo_matrix
    """
    if not sp.issparse(interactions):
        raise ValueError("Interactions must be a scipy.sparse matrix.")

    coo = interactions.tocoo()
    rng = _as_random_state(random_state)

    order = rng.permutation(coo.nnz)
    n_train = int((1.0 - test_percentage) * coo.nnz)

    def _take(idx: np.ndarray) -> sp.coo_matrix:
        return sp.coo_matrix(
            (coo.data[idx], (coo.row[idx], coo.col[idx])),
            shape=coo.shape,
            dtype=coo.dtype,
        )

    return _take(order[:n_train]), _take(order[n_train:])
