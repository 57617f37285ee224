"""Dataset construction utilities.

Counterpart of ``lightfm_tpu/data.py``, with the same classes and results.
Behavioral parity target: ``lightfm/data.py`` in the reference — external
id / feature-name ↔ internal-index mappings with first-seen (insertion)
ordering, COO interaction + weight matrices, and CSR feature matrices with
an optional identity block and L1 row normalisation.

The implementation is built around two paths:

* a **vectorised native path** for numpy integer-array inputs, which routes
  id translation through the C++ ingest engine (``native/ingest.cpp``) and
  assembles matrices with whole-array numpy ops; and
* a **generic iterable path** for arbitrary hashable ids, organised as a
  single triple-collector per matrix (``_extend`` for mappings,
  ``_entries`` for features) rather than the reference's per-element
  builder classes.

One difference from ``lightfm_tpu``: ``INT64_MIN`` is the native engine's
empty-slot marker, so an int array or a mapping that holds it takes the
pure-Python path (``lightfm_tpu`` maps such an id anew on every occurrence,
and its mapping and matrices then disagree).
"""

from __future__ import annotations

import array

import numpy as np
import scipy.sparse as sp

__all__ = ["Dataset"]

# array.array typecodes for the dtypes the incremental builder accepts.
_TYPECODES = {np.int32: "i", np.int64: "l", np.float32: "f", np.float64: "d"}

_INT64_MIN = np.iinfo(np.int64).min  # the native engine's empty-slot marker


def _holds_sentinel(a: np.ndarray) -> bool:
    """True when the signed int array ``a`` holds ``INT64_MIN``, which the
    native engine cannot key (``native/ingest.cpp``)."""
    return a.dtype.kind == "i" and a.size > 0 and a.min() == _INT64_MIN


class _IncrementalCOOMatrix:
    """Append-only COO accumulator backed by compact typed arrays.

    Parity: ``lightfm/data.py:10-52`` (same role; rebuilt around a dtype
    typecode table and a zero-copy numpy view at conversion time).
    """

    def __init__(self, shape, dtype):
        typecode = _TYPECODES.get(dtype)
        if typecode is None:
            raise Exception("Dtype not supported.")
        self.shape = shape
        self.dtype = dtype
        self.rows, self.cols = array.array("i"), array.array("i")
        self.data = array.array(typecode)

    def append(self, i, j, v):
        if not (i < self.shape[0] and j < self.shape[1]):
            raise Exception("Index out of bounds")
        self.rows.append(i)
        self.cols.append(j)
        self.data.append(v)

    def tocoo(self) -> sp.coo_matrix:
        triplet = (
            np.frombuffer(self.data, dtype=self.dtype),
            (
                np.frombuffer(self.rows, dtype=np.int32),
                np.frombuffer(self.cols, dtype=np.int32),
            ),
        )
        return sp.coo_matrix(triplet, shape=self.shape)

    def __len__(self):
        return len(self.data)


def _is_array_input(data) -> bool:
    """True for the TPU-native fast-path input: a 2/3-tuple of numpy arrays."""
    return (
        isinstance(data, tuple)
        and len(data) in (2, 3)
        and all(isinstance(a, np.ndarray) for a in data)
    )


def _mapping_keys_i64(mapping):
    """Mapping keys as an int64 array, or None when any key isn't an int."""
    try:
        return np.fromiter(mapping.keys(), dtype=np.int64, count=len(mapping))
    except (TypeError, ValueError, OverflowError):
        return None


def _translate(keys: np.ndarray, ids, missing_msg: str) -> np.ndarray:
    """Vectorised external-id → internal-index lookup via the native engine.

    ``keys`` is the mapping's key array (first-seen order) from
    :func:`_mapping_keys_i64` — passed in so hot ingestion paths extract it
    once.  Raises ValueError (formatted with the first offending id) on
    misses.  Keys or ids holding ``INT64_MIN`` are looked up in Python.
    """
    from lightfm_tpu_torch import native

    ids64 = np.asarray(ids, dtype=np.int64)
    if _holds_sentinel(keys) or _holds_sentinel(ids64):
        index = {k: i for i, k in enumerate(keys.tolist())}
        idx = np.fromiter((index.get(k, -1) for k in ids64.tolist()), dtype=np.int32,
                          count=ids64.size)
    else:
        idx = native.lookup_ids(keys, ids64)
    misses = idx < 0
    if misses.any():
        raise ValueError(missing_msg.format(np.asarray(ids)[misses][0]))
    return idx


class _FeatureBuilder:
    """Assembles an entity × feature CSR matrix.

    Parity: ``lightfm/data.py:55-133``.  Collects (row, col, weight)
    triples into flat lists — identity block first, then the user-supplied
    features — and normalises rows with direct numpy on the CSR buffers.
    """

    def __init__(self, id_mapping, feature_mapping, identity_features, normalize, entity_type):
        self._id_mapping = id_mapping
        self._feature_mapping = feature_mapping
        self._identity_features = identity_features
        self._normalize = normalize
        self._entity_type = entity_type

    def features_shape(self):
        return len(self._id_mapping), len(self._feature_mapping)

    def _entries(self, data):
        """Yield (row, col, weight) triples for the iterable input form."""
        if self._identity_features:
            for key, row in self._id_mapping.items():
                yield row, self._feature_mapping[key], 1.0

        for datum in data:
            if len(datum) != 2:
                raise ValueError(
                    f"Expected tuples of ({self._entity_type}_id, features), "
                    f"got {datum}."
                )
            entity_id, features = datum
            row = self._id_mapping.get(entity_id)
            if row is None:
                raise ValueError(
                    f"{self._entity_type} id {entity_id} not in "
                    f"{self._entity_type} id mappings."
                )
            pairs = (
                features.items()
                if isinstance(features, dict)
                else ((name, 1.0) for name in features)
            )
            for name, weight in pairs:
                col = self._feature_mapping.get(name)
                if col is None:
                    raise ValueError(
                        f"Feature {name} not in feature mapping. Call fit first."
                    )
                yield row, col, weight

    def _finalize(self, rows, cols, weights) -> sp.csr_matrix:
        mat = sp.coo_matrix(
            (
                np.asarray(weights, dtype=np.float32),
                (np.asarray(rows, dtype=np.int32), np.asarray(cols, dtype=np.int32)),
            ),
            shape=self.features_shape(),
        ).tocsr()
        if self._normalize:
            if np.any(np.diff(mat.indptr) == 0):
                raise ValueError(
                    "Cannot normalize feature matrix: some rows have zero norm. "
                    "Ensure that features were provided for all entries."
                )
            norms = np.abs(mat).sum(axis=1).A.ravel()
            norms[norms == 0.0] = 1.0  # stored-zero rows stay zero, not NaN
            inv_norm = 1.0 / norms
            mat.data = (mat.data * np.repeat(inv_norm, np.diff(mat.indptr))).astype(
                np.float32
            )
        return mat

    def _build_arrays(self, entity_ids, feature_ids, weights) -> sp.csr_matrix:
        """Vectorised build from numpy id arrays via the native engine."""
        from lightfm_tpu_torch import native

        ekeys = _mapping_keys_i64(self._id_mapping)
        fkeys = _mapping_keys_i64(self._feature_mapping)
        if not native.AVAILABLE or ekeys is None or fkeys is None:
            # Mapping keys are not ints (or no compiler): reroute through
            # the generic iterable path.
            if weights is None:
                return self.build((e, [f]) for e, f in zip(entity_ids, feature_ids))
            return self.build(
                (e, {f: w}) for e, f, w in zip(entity_ids, feature_ids, weights)
            )

        rows = _translate(
            ekeys,
            entity_ids,
            "%s id {} not in %s id mappings." % (self._entity_type, self._entity_type),
        )
        cols = _translate(
            fkeys,
            feature_ids,
            "Feature {} not in feature mapping. Call fit first.",
        )
        w = (
            np.ones(rows.size, dtype=np.float32)
            if weights is None
            else np.asarray(weights, dtype=np.float32)
        )
        if self._identity_features:
            id_rows = np.fromiter(
                self._id_mapping.values(), dtype=np.int32, count=len(self._id_mapping)
            )
            id_cols = np.array(
                [self._feature_mapping[k] for k in self._id_mapping], dtype=np.int32
            )
            rows = np.concatenate([id_rows, rows])
            cols = np.concatenate([id_cols, cols])
            w = np.concatenate([np.ones(id_rows.size, dtype=np.float32), w])
        return self._finalize(rows, cols, w)

    def build(self, data) -> sp.csr_matrix:
        if _is_array_input(data):
            return self._build_arrays(
                data[0], data[1], data[2] if len(data) == 3 else None
            )
        rows, cols, weights = [], [], []
        for r, c, w in self._entries(data):
            rows.append(r)
            cols.append(c)
            weights.append(w)
        return self._finalize(rows, cols, weights)


class Dataset:
    """Tool for building interaction and feature matrices, managing the
    mapping between external ids / feature names and internal indices.

    Parity: ``lightfm/data.py:136-449``.
    """

    def __init__(self, user_identity_features=True, item_identity_features=True):
        self._user_identity_features = user_identity_features
        self._item_identity_features = item_identity_features

        self._user_id_mapping = {}
        self._item_id_mapping = {}
        self._user_feature_mapping = {}
        self._item_feature_mapping = {}

    def _check_fitted(self):
        if not self._user_id_mapping or not self._item_id_mapping:
            raise ValueError(
                "You must call fit first to build the item and user id mappings."
            )

    def fit(self, users, items, user_features=None, item_features=None):
        """Fit the user/item id and feature name mappings, resetting existing ones."""
        self._user_id_mapping = {}
        self._item_id_mapping = {}
        self._user_feature_mapping = {}
        self._item_feature_mapping = {}

        return self.fit_partial(users, items, user_features, item_features)

    @staticmethod
    def _extend(mapping: dict, keys) -> None:
        """Append unseen ``keys`` to ``mapping`` in first-seen order.

        Numpy integer arrays take the native C++ dedup path
        (``native/ingest.cpp``, ~40x faster at 10M rows); anything else
        runs the generic insertion loop.  Both assign indices densely in
        encounter order, matching the reference's setdefault semantics
        (``lightfm/data.py:229-257``).
        """
        if keys is None:
            return
        if Dataset._extend_int_array(mapping, keys):
            return
        for key in keys:
            if key not in mapping:
                mapping[key] = len(mapping)

    @staticmethod
    def _extend_int_array(mapping: dict, ids) -> bool:
        """Native-dedup fast path; False when it does not apply."""
        from lightfm_tpu_torch import native

        if not native.AVAILABLE:
            return False
        if not (isinstance(ids, np.ndarray) and ids.dtype.kind in "iu"):
            return False
        if ids.dtype == np.uint64 and ids.size and ids.max() > np.iinfo(np.int64).max:
            # Would wrap negative under int64 — keep the exact Python path.
            return False
        if _holds_sentinel(ids):  # the native map's empty-slot marker
            return False
        existing = (
            _mapping_keys_i64(mapping) if mapping else np.empty(0, dtype=np.int64)
        )
        if existing is None or _holds_sentinel(existing):
            # Mixed-type keys or the marker: the merge must stay in Python.
            return False
        unseen = native.map_ids(existing, ids.astype(np.int64, copy=False))
        start = len(mapping)
        mapping.update(zip(unseen.tolist(), range(start, start + unseen.size)))
        return True

    def fit_partial(self, users=None, items=None, user_features=None, item_features=None):
        """Add new entries to the existing mappings."""
        # Identity features read the SAME input twice; one-shot iterables
        # (generators) must be materialised or the second pass sees nothing.
        def reiterable(x):
            if x is None or isinstance(x, (np.ndarray, list, tuple, range)):
                return x
            return list(x)

        if self._user_identity_features:
            users = reiterable(users)
        if self._item_identity_features:
            items = reiterable(items)

        self._extend(self._user_id_mapping, users)
        if self._user_identity_features:
            self._extend(self._user_feature_mapping, users)

        self._extend(self._item_id_mapping, items)
        if self._item_identity_features:
            self._extend(self._item_feature_mapping, items)

        self._extend(self._user_feature_mapping, user_features)
        self._extend(self._item_feature_mapping, item_features)

    def interactions_shape(self):
        """(num users, num items)."""
        return (len(self._user_id_mapping), len(self._item_id_mapping))

    def _build_interactions_arrays(self, user_ids, item_ids, weights):
        """Native vectorized variant of build_interactions for numpy arrays."""
        from lightfm_tpu_torch import native

        ukeys = _mapping_keys_i64(self._user_id_mapping)
        ikeys = _mapping_keys_i64(self._item_id_mapping)
        if not native.AVAILABLE or ukeys is None or ikeys is None:
            it = (
                zip(user_ids, item_ids)
                if weights is None
                else zip(user_ids, item_ids, weights)
            )
            return self.build_interactions(it)

        uidx = _translate(
            ukeys,
            user_ids,
            "User id {} not in user id mapping. Make sure you call the fit method.",
        )
        iidx = _translate(
            ikeys,
            item_ids,
            "Item id {} not in item id mapping. Make sure you call the fit method.",
        )
        w = (
            np.ones(uidx.size, dtype=np.float32)
            if weights is None
            else np.asarray(weights, dtype=np.float32)
        )
        shape = self.interactions_shape()
        interactions = sp.coo_matrix(
            (np.ones(uidx.size, dtype=np.int32), (uidx, iidx)), shape=shape
        )
        weights_mat = sp.coo_matrix((w, (uidx, iidx)), shape=shape)
        return interactions, weights_mat

    def build_interactions(self, data):
        """Build (interactions, weights) COO matrices.

        ``data`` is either the reference's iterable of (user_id, item_id)
        or (user_id, item_id, weight) tuples (``lightfm/data.py:296-330``),
        or — the TPU-native fast path — a tuple of numpy arrays
        ``(user_ids, item_ids[, weights])`` routed through the native C++
        ingest engine.
        """
        if _is_array_input(data):
            return self._build_interactions_arrays(
                data[0], data[1], data[2] if len(data) == 3 else None
            )

        interactions = _IncrementalCOOMatrix(self.interactions_shape(), np.int32)
        weights = _IncrementalCOOMatrix(self.interactions_shape(), np.float32)

        for datum in data:
            if len(datum) == 2:
                (user_id, item_id), weight = datum, 1.0
            elif len(datum) == 3:
                user_id, item_id, weight = datum
            else:
                raise ValueError(
                    "Expecting tuples of (user_id, item_id, weight) "
                    f"or (user_id, item_id). Got {datum}"
                )
            user_idx = self._user_id_mapping.get(user_id)
            if user_idx is None:
                raise ValueError(
                    f"User id {user_id} not in user id mapping. Make sure "
                    "you call the fit method."
                )
            item_idx = self._item_id_mapping.get(item_id)
            if item_idx is None:
                raise ValueError(
                    f"Item id {item_id} not in item id mapping. Make sure "
                    "you call the fit method."
                )
            interactions.append(user_idx, item_idx, 1)
            weights.append(user_idx, item_idx, weight)

        return (interactions.tocoo(), weights.tocoo())

    def user_features_shape(self):
        """(num user ids, num user features)."""
        return (len(self._user_id_mapping), len(self._user_feature_mapping))

    def build_user_features(self, data, normalize=True):
        """Build a user x feature CSR from (user id, [features]) or
        (user id, {feature: weight}) tuples."""
        return _FeatureBuilder(
            self._user_id_mapping,
            self._user_feature_mapping,
            self._user_identity_features,
            normalize,
            "user",
        ).build(data)

    def item_features_shape(self):
        """(num item ids, num item features)."""
        return (len(self._item_id_mapping), len(self._item_feature_mapping))

    def build_item_features(self, data, normalize=True):
        """Build an item x feature CSR from (item id, [features]) or
        (item id, {feature: weight}) tuples."""
        return _FeatureBuilder(
            self._item_id_mapping,
            self._item_feature_mapping,
            self._item_identity_features,
            normalize,
            "item",
        ).build(data)

    def model_dimensions(self):
        """(num user feature embeddings, num item feature embeddings)."""
        return (len(self._user_feature_mapping), len(self._item_feature_mapping))

    def mapping(self):
        """(user id map, user feature map, item id map, item feature map)."""
        return (
            self._user_id_mapping,
            self._user_feature_mapping,
            self._item_id_mapping,
            self._item_feature_mapping,
        )
