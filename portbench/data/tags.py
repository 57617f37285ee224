"""Item tags made from a seed, in the layout of LightFM's StackExchange data
with ``indicator_features=False, tag_features=True``
(``lightfm/datasets/stackexchange.py``): items described by their tags
alone, each tag of weight 1.0.

Each item has 1 to ``max_tags`` tags, the count uniform.  Its first tag is
one of ``topic_tags`` topic tags of its cluster (the contiguous item range
that :func:`portbench.data.synth.clustered_interactions` ties to a cluster
of users), so tags ``[0, n_clusters * topic_tags)`` are topic tags.  The
rest are drawn without repeat from the other tags by Zipf popularity: tag
``n_clusters * topic_tags + k`` is drawn with weight ``(k + 1) ** -zipf_s``.
Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Draw probabilities of ``n`` tags by rank: ``(k + 1) ** -s``,
    normalised."""
    p = (np.arange(n, dtype=np.float64) + 1.0) ** -float(s)
    return p / p.sum()


def item_tags(n_items: int, seed: int, *, n_tags: int = 2048, topic_tags: int = 16,
              n_clusters: int = 64, max_tags: int = 5, zipf_s: float = 1.0):
    """The ``[n_items, n_tags]`` float32 CSR tag matrix (sorted indices)."""
    n_topic = n_clusters * topic_tags
    n_zipf = n_tags - n_topic
    if n_zipf < max_tags - 1:
        raise ValueError(f"{n_tags} tags leave {n_zipf} beside {n_topic} topic tags")
    rng = np.random.RandomState(seed)
    count = rng.randint(1, max_tags + 1, n_items)
    span = n_items // n_clusters
    cluster = np.minimum(np.arange(n_items) // span, n_clusters - 1)
    tags = np.empty((n_items, max_tags), np.int64)
    tags[:, 0] = cluster * topic_tags + rng.randint(0, topic_tags, n_items)
    # Sequential draws without repeat: a draw that repeats an earlier tag of
    # its item is drawn again, which is a draw from the renormalised law.
    cdf = np.cumsum(zipf_weights(n_zipf, zipf_s))
    for slot in range(1, max_tags):
        todo = np.arange(n_items)
        while todo.size:
            draw = np.minimum(np.searchsorted(cdf, rng.rand(todo.size), side="right"),
                              n_zipf - 1) + n_topic
            tags[todo, slot] = draw
            todo = todo[(tags[todo, 1:slot] == draw[:, None]).any(1)]
    keep = np.arange(max_tags)[None, :] < count[:, None]
    rows = np.repeat(np.arange(n_items), count)
    csr = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, tags[keep])),
                        shape=(n_items, n_tags))
    csr.sort_indices()
    return csr
