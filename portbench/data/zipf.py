"""Popularity-skewed interactions made from a seed (``synth-5m-zipf``).

Users are drawn uniformly; items by Zipf popularity over a seeded
permutation of their ids, so the item of popularity rank ``k`` (counted
from 0) is drawn with weight ``(k + 1) ** -s`` (``tags.zipf_weights``, the
law of the hybrid cell's tags).  This keeps MovieLens's defining property,
a catalog whose head holds a large share of the interactions, which
``synth.clustered_interactions`` (uniform items inside each cluster) lacks.
Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from portbench.data.tags import zipf_weights


def zipf_interactions(n_users: int, n_items: int, draws: int, seed: int, s: float = 1.0):
    """``draws`` (user, item) draws, users uniform and items by Zipf
    popularity of exponent ``s`` over a seeded permutation of the item ids;
    duplicate draws are summed.  Returns the COO matrix (sorted by user,
    then item)."""
    rng = np.random.RandomState(seed)
    item_of_rank = rng.permutation(n_items)
    rows = rng.randint(0, n_users, draws).astype(np.int32)
    cdf = np.cumsum(zipf_weights(n_items, s))
    ranks = np.minimum(np.searchsorted(cdf, rng.rand(draws), side="right"), n_items - 1)
    cols = item_of_rank[ranks].astype(np.int32)
    coo = sp.coo_matrix((np.ones(draws, np.float32), (rows, cols)), shape=(n_users, n_items))
    coo.sum_duplicates()
    return coo
