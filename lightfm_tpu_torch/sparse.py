"""Padded sparse row structures.

Counterpart of ``lightfm_tpu/sparse.py``.  Ragged CSR rows become dense
``[n_rows, max_nnz]`` index/weight tensors padded with zero-weight
entries, which are exact no-ops in every weighted sum, so the read path
needs no masking.  :class:`PaddedSortedRows` keeps each row's columns
sorted and padded with an out-of-range sentinel for the training path's
negative-rejection membership tests (the reference's ``bsearch``,
``_lightfm_fast.pyx.template:270-284``).
"""

from __future__ import annotations

import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch


def content_fingerprint(m) -> tuple:
    """Content checksum of a scipy matrix for identity-keyed caches.

    CRC32 over the raw bytes of ``data`` and ``indices`` (or COO ``col``),
    so in-place edits between calls -- position swaps and compensating
    edits included -- miss the cache instead of returning stale results.
    """
    parts = [getattr(m, "shape", None), getattr(m, "nnz", None)]
    data = getattr(m, "data", None)
    if data is not None and np.size(data):
        parts.append(zlib.crc32(np.ascontiguousarray(data).view(np.uint8)))
    idx = getattr(m, "indices", None)
    if idx is None:
        idx = getattr(m, "col", None)
    if idx is not None and np.size(idx):
        parts.append(zlib.crc32(np.ascontiguousarray(idx).view(np.uint8)))
    return tuple(parts)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class PaddedRows(NamedTuple):
    """Fixed-shape view of a sparse row-major matrix.

    ``idx`` int32 [n_rows, max_nnz] (padding slots hold 0), ``wts`` float32
    [n_rows, max_nnz] (padding slots hold 0.0), ``n_cols`` the column count
    of the original matrix.
    """

    idx: torch.Tensor
    wts: torch.Tensor
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.idx.shape[0]

    @property
    def max_nnz(self) -> int:
        return self.idx.shape[1]


class IdentityRows(NamedTuple):
    """Identity feature matrix (the default / pure-MF case): row i has the
    single feature i with weight 1, so a representation is a table row."""

    n_rows: int

    @property
    def n_cols(self) -> int:
        return self.n_rows

    @property
    def max_nnz(self) -> int:
        return 1


class ChunkedRows(NamedTuple):
    """Width-capped padded rows with a chunked overflow tier.

    Rows keep their first ``base.max_nnz`` features in ``base``; the few
    over-width rows continue into overflow records.  ``over_slot`` int32
    [n_rows] is the row's record, or M (the all-padding record) for rows
    that fit; ``over_idx``/``over_wts`` are chunk-major [n_chunks, M+1, C].
    """

    base: PaddedRows
    over_slot: torch.Tensor
    over_idx: torch.Tensor
    over_wts: torch.Tensor

    @property
    def n_rows(self) -> int:
        return self.base.n_rows

    @property
    def n_cols(self) -> int:
        return self.base.n_cols

    @property
    def max_nnz(self) -> int:
        return self.base.max_nnz + self.over_idx.shape[0] * self.over_idx.shape[2]

    @property
    def n_chunks(self) -> int:
        return self.over_idx.shape[0]


def _ragged_fill(idx, wts, rows, lengths, indices, data, offsets):
    """Scatter CSR entries ``offsets[r] .. offsets[r]+lengths[r]`` of each
    listed row into ``idx/wts[rows]`` left-aligned."""
    total = int(lengths.sum())
    if not total:
        return
    row_of = np.repeat(np.arange(len(rows)), lengths)
    pos = np.arange(total) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    flat = np.repeat(offsets, lengths) + pos
    idx[rows[row_of], pos] = indices[flat].astype(np.int32)
    wts[rows[row_of], pos] = data[flat].astype(np.float32)


def pad_csr(
    csr,
    pad_multiple: int = 1,
    min_width: int = 1,
    width_cap: Optional[int] = None,
    chunk_width: int = 512,
    device="cpu",
):
    """Convert a scipy CSR matrix to :class:`PaddedRows` (or, when rows
    exceed ``width_cap``, :class:`ChunkedRows`) on ``device``.

    ``pad_multiple`` rounds the padded width up; ``width_cap`` bounds the
    dense base tier's width, with longer rows spilling into overflow chunks
    of ``chunk_width`` -- every entry is still represented exactly.
    """
    import scipy.sparse as sp

    def put(a):
        return torch.from_numpy(a).to(device)

    csr = sp.csr_matrix(csr)
    n_rows, n_cols = csr.shape
    lengths = np.diff(csr.indptr)
    max_nnz = int(lengths.max()) if len(lengths) else 0
    width = _round_up(max(max_nnz, min_width, 1), pad_multiple)

    # Compare against the ROUNDED cap C: rows with width_cap < nnz <= C
    # still fit the dense tier.
    C = (
        _round_up(max(width_cap, min_width, 1), pad_multiple)
        if width_cap is not None
        else None
    )
    if width_cap is None or max_nnz <= C:
        idx = np.zeros((n_rows, width), dtype=np.int32)
        wts = np.zeros((n_rows, width), dtype=np.float32)
        _ragged_fill(
            idx, wts, np.arange(n_rows), lengths, csr.indices, csr.data,
            csr.indptr[:-1],
        )
        return PaddedRows(put(idx), put(wts), n_cols)

    base_idx = np.zeros((n_rows, C), dtype=np.int32)
    base_wts = np.zeros((n_rows, C), dtype=np.float32)
    _ragged_fill(
        base_idx, base_wts, np.arange(n_rows), np.minimum(lengths, C),
        csr.indices, csr.data, csr.indptr[:-1],
    )

    over_rows = np.flatnonzero(lengths > C)
    M = len(over_rows)
    over_len = lengths[over_rows] - C
    n_chunks = max(1, -(-int(over_len.max()) // chunk_width))
    over_idx = np.zeros((M + 1, n_chunks * chunk_width), dtype=np.int32)
    over_wts = np.zeros((M + 1, n_chunks * chunk_width), dtype=np.float32)
    _ragged_fill(
        over_idx, over_wts, np.arange(M), over_len, csr.indices, csr.data,
        csr.indptr[:-1][over_rows] + C,
    )
    slot = np.full(n_rows, M, dtype=np.int32)
    slot[over_rows] = np.arange(M, dtype=np.int32)

    def chunk_major(a):
        return np.ascontiguousarray(
            a.reshape(M + 1, n_chunks, chunk_width).transpose(1, 0, 2)
        )

    return ChunkedRows(
        base=PaddedRows(put(base_idx), put(base_wts), n_cols),
        over_slot=put(slot),
        over_idx=put(chunk_major(over_idx)),
        over_wts=put(chunk_major(over_wts)),
    )


def trim_rows(features, n: int):
    """First ``n`` rows of a padded feature structure (any variant)."""
    if isinstance(features, IdentityRows):
        return IdentityRows(min(n, features.n_rows))
    if isinstance(features, ChunkedRows):
        return features._replace(
            base=trim_rows(features.base, n), over_slot=features.over_slot[:n]
        )
    return PaddedRows(features.idx[:n], features.wts[:n], features.n_cols)


def identity_rows(n: int) -> IdentityRows:
    """The identity-features fast path: row i has a single feature i, weight 1."""
    return IdentityRows(int(n))


class PaddedSortedRows(NamedTuple):
    """Per-row sorted indices with an out-of-range sentinel pad.

    ``idx`` int32 [n_rows, width], each row ascending and padded with
    ``n_cols`` (greater than any valid id); ``lengths`` int32 [n_rows] the
    kept entries per row.
    """

    idx: torch.Tensor
    lengths: torch.Tensor
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.idx.shape[0]


def pad_csr_sorted(
    csr, pad_multiple: int = 1, max_width: int | None = None, device="cpu"
) -> PaddedSortedRows:
    """Convert a scipy CSR to sorted, sentinel-padded rows on ``device``.

    ``max_width`` caps the padded width: longer rows keep their first
    ``max_width`` sorted columns, so the membership test is approximate for
    them (statistically safe for negative rejection), and ``lengths`` is
    clipped to the kept width.
    """
    import scipy.sparse as sp

    csr = sp.csr_matrix(csr)
    if not csr.has_sorted_indices:
        csr = csr.sorted_indices()
    n_rows, n_cols = csr.shape
    lengths = np.diff(csr.indptr).astype(np.int32)
    width = max(int(lengths.max()) if len(lengths) else 1, 1)
    if max_width is not None:
        width = min(width, max_width)
    width = _round_up(width, pad_multiple)

    kept = np.minimum(lengths, width)
    idx = np.full((n_rows, width), n_cols, dtype=np.int32)
    if csr.nnz:
        row_of = np.repeat(np.arange(n_rows), kept)
        pos_in_row = np.arange(int(kept.sum())) - np.repeat(np.cumsum(kept) - kept, kept)
        flat = np.repeat(csr.indptr[:-1], kept) + pos_in_row
        idx[row_of, pos_in_row] = csr.indices[flat].astype(np.int32)
    return PaddedSortedRows(
        torch.from_numpy(idx).to(device), torch.from_numpy(kept).to(device), n_cols
    )


def in_positives(
    rows: PaddedSortedRows, row_ids: torch.Tensor, col_ids: torch.Tensor
) -> torch.Tensor:
    """Is ``col_ids[b, ...]`` in row ``row_ids[b]``?  ``row_ids`` is [B],
    ``col_ids`` [B] or [B, K]; returns bool of ``col_ids``'s shape.  Each
    row's list is gathered once and broadcast against its queries; the
    sentinel pad never matches a valid id."""
    table = rows.idx[row_ids.long()]  # [B, width]
    if col_ids.dim() == row_ids.dim():
        return (table == col_ids[..., None]).any(-1)
    return (table[..., None, :] == col_ids[..., None]).any(-1)


def in_positives_slots(
    rows: PaddedSortedRows, row_ids: torch.Tensor, col_ids: torch.Tensor
) -> torch.Tensor:
    """Slot-major :func:`in_positives`: ``col_ids`` is [K, B] (candidate
    slot k of batch row b); returns bool [K, B]."""
    table = rows.idx[row_ids.long()]  # [B, width]
    return (table[None, :, :] == col_ids[:, :, None]).any(-1)
