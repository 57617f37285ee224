"""The host-side slice as a whole, in both packages: raw external ids go
through ``Dataset`` (mappings, interactions, item features with tags),
``random_train_test_split``, a hybrid WARP ``LightFM.fit`` and test-split
``auc_score`` / ``precision_at_k``.  Every matrix must be equal in the two
packages; the whole fits draw different random numbers, so they compare by
quality: the port's test AUC within 0.03 of the JAX package's (the band of
``tests/test_torch_generic_fit.py``)."""

import numpy as np
import pytest
import torch

import lightfm_tpu
from lightfm_tpu import cross_validation as jax_cv
from lightfm_tpu import data as jax_data
from lightfm_tpu import evaluation as jax_eval

import lightfm_tpu_torch
from lightfm_tpu_torch import cross_validation, data, evaluation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw_log(seed=0, n_users=300, n_items=240, n_clusters=8, per_user=24, n_tags=32):
    """A clustered log of distinct (user, item) pairs with scrambled int64
    ids, as ``chip_smoke.py``'s phase 9 makes it: users prefer a contiguous
    item range (80% of draws), items carry one block tag and two noise
    tags."""
    rng = np.random.RandomState(seed)
    cluster = rng.randint(0, n_clusters, n_users)
    span = n_items // n_clusters
    rows = np.repeat(np.arange(n_users), per_user)
    rng.shuffle(rows)
    in_pref = rng.rand(rows.size) < 0.8
    cols = np.where(in_pref, cluster[rows] * span + rng.randint(0, span, rows.size),
                    rng.randint(0, n_items, rows.size))
    # One line per (user, item) pair, in first-seen order, so the split
    # cannot put one pair on both sides.
    _, first = np.unique(rows * n_items + cols, return_index=True)
    rows, cols = rows[np.sort(first)], cols[np.sort(first)]
    user_ext = 10**12 + 7919 * rng.permutation(n_users).astype(np.int64)
    item_ext = 2 * 10**12 + 7919 * rng.permutation(n_items).astype(np.int64)
    tag_ext = 10**15 + np.arange(n_tags, dtype=np.int64)
    block = np.arange(n_items) * (n_tags // 2) // n_items
    noise = n_tags // 2 + rng.randint(0, n_tags // 2, (n_items, 2))
    tag_cols = np.concatenate([block[:, None], noise], axis=1).ravel()
    return (user_ext[rows], item_ext[cols], rng.rand(rows.size).astype(np.float32),
            item_ext, np.repeat(item_ext, 3), tag_ext[tag_cols], tag_ext)


def _pipeline(pkg_data, pkg_cv, seed=0):
    u, i, w, items, feat_items, feat_tags, tags = _raw_log(seed)
    ds = pkg_data.Dataset()
    ds.fit(u, i, item_features=tags)
    ds.fit_partial(items=items)
    interactions, weights = ds.build_interactions((u, i, w))
    feats = ds.build_item_features((feat_items, feat_tags), normalize=False)
    feats_l1 = ds.build_item_features((feat_items, feat_tags), normalize=True)
    train, test = pkg_cv.random_train_test_split(interactions, test_percentage=0.2,
                                                 random_state=seed)
    return ds, [interactions, weights, feats, feats_l1, train, test]


def test_raw_ids_to_evaluated_hybrid_model_matches_jax():
    ds, got = _pipeline(data, cross_validation)
    ref, want = _pipeline(jax_data, jax_cv)
    assert ds.mapping() == ref.mapping()
    for g, w in zip(got, want):
        assert type(g) is type(w) and g.shape == w.shape and g.dtype == w.dtype
        g, w = g.tocoo(), w.tocoo()
        for name in ("row", "col", "data"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
    interactions, _, feats, feats_l1, train, test = got
    np.testing.assert_allclose(np.asarray(feats_l1.sum(axis=1)).ravel(), 1.0, atol=1e-6)
    assert interactions.shape == (300, 240) and feats.shape == (240, 240 + 32)

    kw = dict(loss="warp", no_components=16, random_state=3)
    port = lightfm_tpu_torch.LightFM(device="cpu", **kw).fit(train, item_features=feats, epochs=10)
    jax_model = lightfm_tpu.LightFM(**kw).fit(train, item_features=feats, epochs=10)
    auc = float(evaluation.auc_score(port, test, train_interactions=train,
                                     item_features=feats).mean())
    ref_auc = float(np.asarray(jax_eval.auc_score(jax_model, test, train_interactions=train,
                                                  item_features=feats)).mean())
    p5 = float(evaluation.precision_at_k(port, test, train_interactions=train, k=5,
                                         item_features=feats).mean())
    ref_p5 = float(np.asarray(jax_eval.precision_at_k(jax_model, test, train_interactions=train,
                                                      k=5, item_features=feats)).mean())
    assert ref_auc > 0.75, ref_auc  # the clusters were learned
    assert abs(auc - ref_auc) <= 0.03, (auc, ref_auc)
    assert p5 > 0.5 * ref_p5, (p5, ref_p5)
