"""MovieLens 100k fetcher (mirrors ``lightfm/datasets/movielens.py``).

Counterpart of ``lightfm_tpu/datasets/movielens.py``; its text parse runs on
the port's native ingest engine where ``g++`` is present.

Returns the same dictionary: train/test COO interaction matrices,
indicator and/or genre item features, and label arrays.  The download is
cached in ``~/lightfm_data`` and the same corrupted-zip recovery applies
(`movielens.py:179-188` in the reference).
"""

from __future__ import annotations

import os
import zipfile

import numpy as np
import scipy.sparse as sp

from lightfm_tpu_torch.datasets import _common

MOVIELENS_URL = (
    "https://github.com/maciejkula/lightfm_datasets/releases/"
    "download/v0.1.0/movielens.zip"
)


def _read_raw_data(path):
    """Raw lines of the train/test/item/genre files inside the zip."""
    with zipfile.ZipFile(path) as datafile:
        return (
            datafile.read("ml-100k/ua.base").decode().split("\n"),
            datafile.read("ml-100k/ua.test").decode().split("\n"),
            datafile.read("ml-100k/u.item").decode(errors="ignore").split("\n"),
            datafile.read("ml-100k/u.genre").decode(errors="ignore").split("\n"),
        )


def _parse_interactions(lines):
    """Parse `uid \\t iid \\t rating \\t timestamp` lines to 0-based arrays."""
    from lightfm_tpu_torch import native

    if native.AVAILABLE:
        buf = "\n".join(lines).encode()
        uids, iids, vals = native.parse_interactions(buf, delim=b"\t")
        return uids - 1, iids - 1, vals.astype(np.int64)

    rows = []
    for line in lines:
        if not line:
            continue
        uid, iid, rating, ts = (int(x) for x in line.split("\t"))
        rows.append((uid - 1, iid - 1, rating))
    out = np.asarray(rows, dtype=np.int64)
    return out[:, 0], out[:, 1], out[:, 2]


def _build_interaction_matrix(rows, cols, uids, iids, ratings, min_rating):
    keep = ratings >= min_rating
    return sp.coo_matrix(
        (ratings[keep].astype(np.int32), (uids[keep], iids[keep])),
        shape=(rows, cols),
        dtype=np.int32,
    )


def _parse_item_metadata(num_items, item_lines, genre_lines):
    genres = [
        "genre:{}".format(line.split("|")[0]) for line in genre_lines if line
    ]

    id_feature_labels = np.empty(num_items, dtype=object)
    id_feature_labels[:] = ""
    genre_feature_labels = np.array(genres)

    id_features = sp.identity(num_items, format="csr", dtype=np.float32)

    g_rows, g_cols = [], []
    for line in item_lines:
        if not line:
            continue
        parts = line.split("|")
        iid = int(parts[0]) - 1
        id_feature_labels[iid] = parts[1]
        for gid, flag in enumerate(parts[5:]):
            if int(flag) > 0:
                g_rows.append(iid)
                g_cols.append(gid)

    genre_features = sp.coo_matrix(
        (np.ones(len(g_rows), dtype=np.float32), (g_rows, g_cols)),
        shape=(num_items, len(genres)),
    ).tocsr()

    return id_features, id_feature_labels, genre_features, genre_feature_labels


def fetch_movielens(
    data_home=None,
    indicator_features=True,
    genre_features=False,
    min_rating=0.0,
    download_if_missing=True,
):
    """Fetch the MovieLens 100k dataset.

    Returns a dict with keys ``train``, ``test`` (COO interactions),
    ``item_features`` (CSR), ``item_feature_labels``, ``item_labels`` —
    identical structure to the reference fetcher (`movielens.py:107-231`).
    """
    if not (indicator_features or genre_features):
        raise ValueError(
            "At least one of item_indicator_features or genre_features must be True"
        )

    zip_path = _common.get_data(
        data_home, MOVIELENS_URL, "movielens100k", "movielens.zip", download_if_missing
    )

    try:
        train_raw, test_raw, item_raw, genres_raw = _read_raw_data(zip_path)
    except zipfile.BadZipFile:
        os.unlink(zip_path)
        raise ValueError(
            "Corrupted Movielens download. Check your internet connection and try again."
        )

    tr_u, tr_i, tr_r = _parse_interactions(train_raw)
    te_u, te_i, te_r = _parse_interactions(test_raw)

    num_users = int(max(tr_u.max(), te_u.max())) + 1
    num_items = int(max(tr_i.max(), te_i.max())) + 1

    train = _build_interaction_matrix(num_users, num_items, tr_u, tr_i, tr_r, min_rating)
    test = _build_interaction_matrix(num_users, num_items, te_u, te_i, te_r, min_rating)
    assert train.shape == test.shape

    id_features, id_labels, genre_mat, genre_labels = _parse_item_metadata(
        num_items, item_raw, genres_raw
    )
    assert id_features.shape == (num_items, len(id_labels))
    assert genre_mat.shape == (num_items, len(genre_labels))

    if indicator_features and not genre_features:
        features = id_features
        feature_labels = id_labels
    elif genre_features and not indicator_features:
        features = genre_mat
        feature_labels = genre_labels
    else:
        features = sp.hstack([id_features, genre_mat]).tocsr()
        feature_labels = np.concatenate((id_labels, genre_labels))

    return {
        "train": train,
        "test": test,
        "item_features": features,
        "item_feature_labels": feature_labels,
        "item_labels": id_labels,
    }
