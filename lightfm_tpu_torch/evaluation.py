"""Rank-based evaluation metrics.

A copy of ``lightfm_tpu/evaluation.py:21-198`` (numpy only).  Behavioral
parity target: ``lightfm/evaluation.py`` -- the four public metrics and
their exact semantics (pessimistic ``>=`` ties, zero-positive rows dropped
unless ``preserve_rows``, 0.5 AUC for single-class users).  All four derive
from :meth:`LightFM.predict_rank`; the O(test_nnz) rank->metric reductions
run as vectorised host numpy.  ``auc_score`` reproduces
``calculate_auc_from_rank`` (`_lightfm_fast.pyx.template:1326-1376`)
including its tie de-duplication.
"""

from __future__ import annotations

import numpy as np

__all__ = ["precision_at_k", "recall_at_k", "auc_score", "reciprocal_rank"]


def _ranks_for(
    model,
    test_interactions,
    train_interactions,
    user_features,
    item_features,
    num_threads,
    check_intersections,
):
    """Shared front half of every metric: validate, rank the test set."""
    if num_threads < 1:
        raise ValueError("Number of threads must be 1 or larger.")
    return model.predict_rank(
        test_interactions,
        train_interactions=train_interactions,
        user_features=user_features,
        item_features=item_features,
        num_threads=num_threads,
        check_intersections=check_intersections,
    )


def _drop_empty_rows(values, test_interactions, preserve_rows):
    """The reference averages only over users WITH test positives."""
    if preserve_rows:
        return values
    return values[test_interactions.getnnz(axis=1) > 0]


def _hits_below_k(ranks, k) -> np.ndarray:
    """Per-user count of stored ranks < k (implicit zeros are NOT ranks)."""
    csr = ranks.tocsr()
    lengths = np.diff(csr.indptr)
    row_of = np.repeat(np.arange(csr.shape[0]), lengths)
    return np.bincount(
        row_of, weights=(csr.data < k), minlength=csr.shape[0]
    )


def precision_at_k(
    model,
    test_interactions,
    train_interactions=None,
    k=10,
    user_features=None,
    item_features=None,
    preserve_rows=False,
    num_threads=1,
    check_intersections=True,
):
    """Fraction of known positives in the first k ranked results per user.

    Parity: `lightfm/evaluation.py:14-87`.
    """
    ranks = _ranks_for(
        model, test_interactions, train_interactions, user_features,
        item_features, num_threads, check_intersections,
    )
    return _drop_empty_rows(
        _hits_below_k(ranks, k) / k, test_interactions, preserve_rows
    )


def recall_at_k(
    model,
    test_interactions,
    train_interactions=None,
    k=10,
    user_features=None,
    item_features=None,
    preserve_rows=False,
    num_threads=1,
    check_intersections=True,
):
    """Hits in the first k over number of test positives per user.

    Parity: `lightfm/evaluation.py:90-166`.
    """
    ranks = _ranks_for(
        model, test_interactions, train_interactions, user_features,
        item_features, num_threads, check_intersections,
    )
    hits = _hits_below_k(ranks, k)
    n_pos = test_interactions.getnnz(axis=1)
    hits = _drop_empty_rows(hits, test_interactions, preserve_rows)
    n_pos = _drop_empty_rows(n_pos, test_interactions, preserve_rows)
    return hits / n_pos


def _auc_from_ranks(ranks_csr, num_train_positives):
    """Vectorised port of ``calculate_auc_from_rank`` (template:1326-1376).

    Per user: sort positive ranks ascending, subtract the number of
    better-ranked positives (floor 0), average ``1 - rank/num_negatives``.
    """
    n_users, n_items = ranks_csr.shape
    indptr = ranks_csr.indptr
    lengths = np.diff(indptr)
    auc = np.full(n_users, 0.5, dtype=np.float32)

    if ranks_csr.nnz == 0:
        return auc

    row_of = np.repeat(np.arange(n_users), lengths)
    # Sort ranks within each row: lexsort by (rank, row).
    order = np.lexsort((ranks_csr.data, row_of))
    sorted_ranks = ranks_csr.data[order].astype(np.float64)
    pos_in_row = np.arange(ranks_csr.nnz) - np.repeat(indptr[:-1], lengths)

    adj = np.maximum(sorted_ranks - pos_in_row, 0.0)
    num_neg = (n_items - lengths - num_train_positives).astype(np.float64)
    num_neg_per_nnz = num_neg[row_of]

    with np.errstate(divide="ignore", invalid="ignore"):
        contrib = 1.0 - adj / num_neg_per_nnz

    nonzero = lengths > 0
    sums = np.add.reduceat(contrib, indptr[:-1][nonzero])
    user_auc = sums / lengths[nonzero]

    # Single-class users keep 0.5 (template:1344-1348).
    auc_vals = np.full(int(nonzero.sum()), 0.5, dtype=np.float64)
    keep = num_neg[nonzero] != n_items
    auc_vals[keep] = user_auc[keep]
    auc[nonzero] = auc_vals.astype(np.float32)
    return auc


def auc_score(
    model,
    test_interactions,
    train_interactions=None,
    user_features=None,
    item_features=None,
    preserve_rows=False,
    num_threads=1,
    check_intersections=True,
):
    """ROC AUC per user.

    Parity: `lightfm/evaluation.py:169-254`.
    """
    ranks = _ranks_for(
        model, test_interactions, train_interactions, user_features,
        item_features, num_threads, check_intersections,
    )
    assert np.all(ranks.data >= 0)

    n_train_pos = (
        np.asarray(train_interactions.getnnz(axis=1), dtype=np.int32).ravel()
        if train_interactions is not None
        else np.zeros(test_interactions.shape[0], dtype=np.int32)
    )
    auc = _auc_from_ranks(ranks.tocsr(), n_train_pos)
    return _drop_empty_rows(auc, test_interactions, preserve_rows)


def reciprocal_rank(
    model,
    test_interactions,
    train_interactions=None,
    user_features=None,
    item_features=None,
    preserve_rows=False,
    num_threads=1,
    check_intersections=True,
):
    """1 / rank of the best-ranked test positive.

    Parity: `lightfm/evaluation.py:257-327`.
    """
    ranks = _ranks_for(
        model, test_interactions, train_interactions, user_features,
        item_features, num_threads, check_intersections,
    )
    ranks.data = 1.0 / (ranks.data + 1.0)
    best = np.asarray(ranks.max(axis=1).todense()).ravel()
    return _drop_empty_rows(best, test_interactions, preserve_rows)
