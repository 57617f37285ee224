"""Synthetic inputs made from a seed: interactions, held-out test items and
planted weights.

``clustered_interactions`` is a frozen copy of ``chip_smoke.py``'s
(itself a copy of ``bench.py:116-149``), with every random stream seeded
from the run's seed.  Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def sub_seed(seed: int, stream: str) -> int:
    """A 32-bit seed for one named stream of a run's ``seed`` (any
    non-negative integer, wider than 32 bits included)."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [ord(c) for c in stream]
    return int(np.random.SeedSequence(words).generate_state(1)[0])


def clustered_interactions(n_users: int, n_items: int, nnz: int, seed: int,
                           n_clusters: int = 64):
    """Users belong to clusters, each preferring a contiguous item range
    (80% of draws in range); duplicate draws are summed.  Returns the COO
    matrix (sorted by user, then item) and each user's cluster."""
    rng = np.random.RandomState(seed)
    cluster = rng.randint(0, n_clusters, n_users)
    span = n_items // n_clusters
    rows = rng.randint(0, n_users, nnz).astype(np.int32)
    in_pref = rng.rand(nnz) < 0.8
    lo = cluster[rows] * span
    cols = np.where(in_pref, lo + rng.randint(0, span, nnz),
                    rng.randint(0, n_items, nnz)).astype(np.int32)
    coo = sp.coo_matrix((np.ones(nnz, np.float32), (rows, cols)), shape=(n_users, n_items))
    coo.sum_duplicates()
    return coo, cluster


def held_out(train, cluster, n_test_users: int, per_user: int, seed: int,
             n_clusters: int = 64, draws: int = 32):
    """Test interactions: ``n_test_users`` distinct users, each with
    ``per_user`` distinct items drawn by :func:`clustered_interactions`'
    law (80% in the user's cluster range) and not among its ``train``
    positives.  Returns a CSR matrix of ``train``'s shape."""
    n_users, n_items = train.shape
    rng = np.random.RandomState(seed)
    users = np.sort(rng.choice(n_users, n_test_users, replace=False))
    span = n_items // n_clusters
    lo = (cluster[users] * span)[:, None]
    in_pref = rng.rand(n_test_users, draws) < 0.8
    cand = np.where(in_pref, lo + rng.randint(0, span, (n_test_users, draws)),
                    rng.randint(0, n_items, (n_test_users, draws))).astype(np.int64)
    csr = train.tocsr()
    keys = np.sort(csr.indices.astype(np.int64) + n_items * np.repeat(
        np.arange(n_users, dtype=np.int64), np.diff(csr.indptr)))
    want = cand + n_items * users[:, None].astype(np.int64)
    at = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
    ok = keys[at] != want
    # Keep each item's first draw in its row.
    order = np.argsort(cand, axis=1, kind="stable")
    srt = np.take_along_axis(cand, order, axis=1)
    first = np.ones_like(ok)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    dup = np.empty_like(ok)
    np.put_along_axis(dup, order, ~first, axis=1)
    ok &= ~dup
    if int(ok.sum(1).min()) < per_user:
        raise RuntimeError(f"fewer than {per_user} fresh items in {draws} draws for a user")
    take = ok & (np.cumsum(ok, axis=1) <= per_user)
    cols = cand[take].reshape(n_test_users, per_user)
    rows = np.repeat(users, per_user)
    return sp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols.ravel())),
                         shape=(n_users, n_items))


def planted_tables(torch, n_users: int, n_items: int, D: int, W: int, cluster,
                   n_clusters: int, seed: int, device):
    """Serving weights made on ``device`` from ``seed``: user and item rows
    near their cluster's centroid, ``(centroid + 0.5 z) / sqrt(D)``, with
    biases ``0.1 z``, in the fused ``[emb | zeros | bias]`` layout of width
    ``W``.  Items take the cluster whose range holds them.  Returns
    ``(user_table, item_table)`` as float32."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    centroids = torch.randn((n_clusters, D), generator=gen, device=device)
    span = n_items // n_clusters
    item_c = torch.clamp(torch.arange(n_items, device=device) // span, max=n_clusters - 1)
    user_c = torch.as_tensor(np.asarray(cluster), device=device).long()

    def table(clusters):
        n = clusters.shape[0]
        t = torch.zeros((n, W), dtype=torch.float32, device=device)
        t[:, :D] = (centroids[clusters] + 0.5 * torch.randn((n, D), generator=gen,
                                                            device=device)) / D ** 0.5
        t[:, -1] = 0.1 * torch.randn((n,), generator=gen, device=device)
        return t

    user = table(user_c)
    item = table(item_c)
    return user, item
