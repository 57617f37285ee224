"""StackExchange dataset fetcher.

Counterpart of ``lightfm_tpu/datasets/stackexchange.py``.

Behavioral parity target: ``lightfm/datasets/stackexchange.py:10-165`` in
the reference.  Interactions are users answering questions, valued by
timestamp; the split is time-based (everything strictly before the cutoff
timestamp trains, the rest tests), with optional filtering of low-activity
users and optional question-tag item features.

The npz archive schema fixes the *loading* keys; everything downstream
(split, filter, feature assembly) is implemented fresh here: the cutoff is
found with ``np.partition`` rather than a full sort, the user filter
remaps COO rows directly instead of round-tripping through CSR slicing,
and feature blocks are assembled through one hstack path.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

from lightfm_tpu_torch.datasets import _common

_RELEASE = "https://github.com/maciejkula/lightfm_datasets/releases/download/v0.1.0"
URLS = {name: f"{_RELEASE}/stackexchange_{name}.npz" for name in ("crossvalidated", "stackoverflow")}


def _load_npz_coo(data, prefix: str) -> sp.coo_matrix:
    """Reassemble one COO matrix from the release archive's key triplets."""
    return sp.coo_matrix(
        (data[f"{prefix}_data"], (data[f"{prefix}_row"], data[f"{prefix}_col"])),
        shape=tuple(data[f"{prefix}_shape"].ravel()),
    )


def _binarized(src: sp.coo_matrix, mask: np.ndarray) -> sp.coo_matrix:
    """COO of ones at the masked entries of ``src`` (timestamps discarded)."""
    r, c = src.row[mask], src.col[mask]
    return sp.coo_matrix(
        (np.ones(r.size, dtype=np.float32), (r, c)), shape=src.shape
    )


def _drop_sparse_users(
    train: sp.coo_matrix, test: sp.coo_matrix, min_interactions: int
):
    """Keep only users with > ``min_interactions`` training rows.

    Surviving users are renumbered densely (matching the reference's CSR
    row-slicing semantics, ``stackexchange.py:138-142``), applied to both
    matrices so user ids stay aligned.
    """
    per_user = np.bincount(train.row, minlength=train.shape[0])
    keep = per_user > min_interactions
    new_row = np.cumsum(keep) - 1  # old id -> new id for kept users
    n_kept = int(keep.sum())

    def _remap(mat: sp.coo_matrix) -> sp.coo_matrix:
        sel = keep[mat.row]
        return sp.coo_matrix(
            (mat.data[sel], (new_row[mat.row[sel]], mat.col[sel])),
            shape=(n_kept, mat.shape[1]),
        )

    return _remap(train), _remap(test)


def _assemble_item_features(
    n_items: int, tags: sp.coo_matrix, tag_labels, indicator: bool, use_tags: bool
):
    """Stack the requested feature blocks: [identity | tags]."""
    blocks, label_parts = [], []
    if indicator:
        blocks.append(sp.identity(n_items, format="csr", dtype=np.float32))
        label_parts.append(
            np.array([f"question_id:{q}" for q in range(n_items)])
        )
    if use_tags:
        blocks.append(tags.tocsr())
        label_parts.append(tag_labels)
    features = blocks[0] if len(blocks) == 1 else sp.hstack(blocks).tocsr()
    labels = label_parts[0] if len(label_parts) == 1 else np.concatenate(label_parts)
    return features.tocsr(), labels


def fetch_stackexchange(
    dataset: str,
    test_set_fraction: float = 0.2,
    min_training_interactions: int = 1,
    data_home=None,
    indicator_features: bool = True,
    tag_features: bool = False,
    download_if_missing: bool = True,
) -> dict:
    """Fetch a StackExchange dataset (``'crossvalidated'`` or ``'stackoverflow'``).

    Returns ``{"train", "test", "item_features", "item_feature_labels"}`` with
    the same shapes/semantics as the reference fetcher: COO train/test of
    binarized interactions split at a timestamp quantile, and a CSR item
    feature matrix of identity and/or tag columns.
    """
    if not (indicator_features or tag_features):
        raise ValueError(
            "At least one of item_indicator_features or tag_features must be True"
        )
    if dataset not in URLS:
        raise ValueError("Unknown dataset")
    if not (0.0 < test_set_fraction < 1.0):
        raise ValueError("Test set fraction must be between 0 and 1")

    path = _common.get_data(
        data_home,
        URLS[dataset],
        os.path.join("stackexchange", dataset),
        "data.npz",
        download_if_missing,
    )
    archive = np.load(path)

    interactions = _load_npz_coo(archive, "interactions")
    interactions.sum_duplicates()
    tags = _load_npz_coo(archive, "features")

    # Time-based split: the cutoff is the (1 - fraction)-quantile timestamp;
    # strictly-earlier interactions train, the rest test (reference :118-121).
    cutoff_rank = int(interactions.nnz * (1.0 - test_set_fraction))
    cutoff_ts = np.partition(interactions.data, cutoff_rank)[cutoff_rank]
    is_train = interactions.data < cutoff_ts

    train = _binarized(interactions, is_train)
    test = _binarized(interactions, ~is_train)

    if min_training_interactions > 0:
        train, test = _drop_sparse_users(train, test, min_training_interactions)

    features, labels = _assemble_item_features(
        train.shape[1], tags, archive["labels"], indicator_features, tag_features
    )

    return {
        "train": train,
        "test": test,
        "item_features": features,
        "item_feature_labels": labels,
    }
