"""Synthetic implicit-feedback dataset with planted low-rank structure.

Counterpart of ``lightfm_tpu/datasets/synthetic.py``: the same
``RandomState`` draws, so the same seed gives bitwise the same arrays.

The reference validates its workload statistically against MovieLens 100k
(`tests/test_movielens.py`).  In network-isolated environments the download
is impossible, so this module provides a deterministic generator with the
same dictionary shape as :func:`fetch_movielens` and comparable statistical
structure: planted user/item factors, popularity skew, per-user holdout test
split.  Used by the test suite and the benchmark harness as the offline
stand-in; when the real MovieLens zip is cached locally the fetchers pick it
up instead.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def generate_synthetic(
    n_users: int = 943,
    n_items: int = 1682,
    rank: int = 8,
    interactions_per_user: int = 106,  # ML-100k averages ~106
    test_per_user: int = 10,  # ua.test holds out 10 per user
    noise: float = 1.0,
    popularity_skew: float = 1.0,
    seed: int = 42,
    user_block: int = 4096,
):
    """Generate a planted-structure implicit dataset.

    Items are chosen per user by Gumbel top-k over
    ``beta * <u, v> + skew * log(popularity) + noise`` — i.e. users prefer
    items aligned with their latent factors, moderated by a Zipf popularity
    prior.  Ratings 1-5 follow ML-100k's global histogram, correlated with
    within-user preference.

    Marginals are tuned to MovieLens 100k at default arguments (measured /
    real): rating histogram 6.1/11.3/27.2/34.2/21.2 vs 6.1/11.4/27.1/34.2/
    21.2 %, user degrees min/median/mean/max 20/68/101/737 vs 20/65/106/737,
    ~95k vs 100k interactions; beta=4.5 calibrates WARP learnability to the
    reference's real-data floors (train AUC ~0.94, p@5 ~0.6).  Known deltas:
    the degree tail is lognormal (real data is slightly heavier above ~400),
    the most-popular item draws ~740 vs 583 interactions, and logistic-loss
    train AUC runs ~0.73 vs the reference's 0.84.

    The logistic gap is structural, not a noise-tuning issue (measured):
    adding a cross-user item-quality component to the rating
    assignment (the feature real ratings have and pure ``<u, v>`` lacks)
    raises the *rating-level* pairwise AUC to real-data levels (0.88 ->
    0.95 train at gamma=1.5) but leaves the *ranking* AUC that the floor
    measures unchanged (0.731 -> 0.732), while diluting the planted
    preference signal the pairwise-loss floors depend on (WARP train AUC
    0.943 -> 0.930, breaking the adadelta/k-OS margins).  Ranking AUC on
    the twin is bound by each user's positives being defined *within* their
    chosen set, so item-level label consistency adds nothing the item bias
    has not already learned.  Real-dataset logistic parity is therefore
    proven on real data instead: ``tests/test_movielens_real.py`` runs the
    reference's exact MovieLens thresholds whenever the zip is cached.

    Returns the same dict shape as :func:`fetch_movielens`:
    ``{train, test, item_features, item_feature_labels, item_labels}``.
    """
    rng = np.random.RandomState(seed)

    U = rng.randn(n_users, rank).astype(np.float32) / np.sqrt(rank)
    V = rng.randn(n_items, rank).astype(np.float32) / np.sqrt(rank)
    # Zipf-ish popularity prior.
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    rng.shuffle(pop)
    log_pop = popularity_skew * np.log(pop).astype(np.float32)

    # Degree distribution tuned to ML-100k's marginals: user interaction
    # counts are lognormal with mean/median ~= 106/65 (sigma ~0.95), floored
    # at 20 (the dataset's hard minimum) and capped at 737 (its heaviest
    # user) scaled to the requested size.  Delta vs real data: the true
    # degree tail is slightly heavier than lognormal above ~400.
    scale = interactions_per_user / 106.0
    counts = np.clip(
        rng.lognormal(mean=np.log(0.61 * interactions_per_user), sigma=0.95, size=n_users),
        max(test_per_user + 5, int(round(20 * scale))),
        min(n_items // 2, max(int(round(737 * scale)), test_per_user + 10)),
    ).astype(np.int64)

    rows, cols, ratings = [], [], []
    for start in range(0, n_users, user_block):
        stop = min(start + user_block, n_users)
        scores = U[start:stop] @ V.T  # [ub, n_items]
        keys = (
            4.5 * scores
            + log_pop[None, :]
            + noise * rng.gumbel(size=scores.shape).astype(np.float32)
        )
        order = np.argsort(-keys, axis=1)
        for u_local in range(stop - start):
            c = counts[start + u_local]
            chosen = order[u_local, :c]
            s = scores[u_local, chosen]
            # Rating = within-user score quantile mapped through ML-100k's
            # GLOBAL rating histogram (1:6.1%, 2:11.4%, 3:27.1%, 4:34.2%,
            # 5:21.2%) so the marginal rating distribution matches the real
            # dataset while staying correlated with preference.
            q = (np.argsort(np.argsort(s)) + 0.5) / max(len(s), 1)
            r = 1 + np.searchsorted(
                [0.0611, 0.1748, 0.4462, 0.7880], q, side="right"
            )
            rows.append(np.full(c, start + u_local, dtype=np.int32))
            cols.append(chosen.astype(np.int32))
            ratings.append(np.clip(r, 1, 5).astype(np.int32))

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    ratings = np.concatenate(ratings)

    # Per-user holdout: the first `test_per_user` of a random permutation.
    test_mask = np.zeros(len(rows), dtype=bool)
    order = rng.permutation(len(rows))
    seen = {}
    for idx in order:
        u = rows[idx]
        c = seen.get(u, 0)
        if c < test_per_user:
            test_mask[idx] = True
            seen[u] = c + 1

    def build(mask):
        return sp.coo_matrix(
            (ratings[mask], (rows[mask], cols[mask])),
            shape=(n_users, n_items),
            dtype=np.int32,
        )

    item_labels = np.array(["item:{}".format(i) for i in range(n_items)])

    # Genre-style metadata CORRELATED with the planted factors (like real
    # genres correlate with preferences): the genre id encodes the sign
    # pattern of the item's leading latent dimensions, so feature-only
    # (cold-start) models have signal to learn from.
    n_genre_bits = min(5, rank)
    genre_of = np.zeros(n_items, dtype=np.int64)
    for b in range(n_genre_bits):
        genre_of |= (V[:, b] > 0).astype(np.int64) << b
    genre_features = sp.csr_matrix(
        (np.ones(n_items, np.float32), (np.arange(n_items), genre_of)),
        shape=(n_items, 1 << n_genre_bits),
    )
    genre_labels = np.array(
        ["genre:{}".format(g) for g in range(1 << n_genre_bits)]
    )

    return {
        "train": build(~test_mask),
        "test": build(test_mask),
        "item_features": sp.identity(n_items, format="csr", dtype=np.float32),
        "item_feature_labels": item_labels,
        "item_labels": item_labels,
        "item_genre_features": genre_features,
        "item_genre_labels": genre_labels,
    }
