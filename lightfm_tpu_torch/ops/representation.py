"""Latent representation and scoring ops.

Counterpart of ``lightfm_tpu/ops/representation.py:22-127``.
Representations are ``[..., W]`` rows whose last element is the summed
bias (the reference's layout, ``_lightfm_fast.pyx.template:305``); tables
store that layout directly, so identity features are one row gather.

Every table read goes through :func:`table_rows`, which under a mesh
asks the table's placement for the whole rows, so everything after it
computes as over a replicated table.
"""

from __future__ import annotations

import contextlib

import torch

from lightfm_tpu_torch.sparse import ChunkedRows, IdentityRows


@contextlib.contextmanager
def ieee_fp32(x: torch.Tensor):
    """CUDA matmuls inside the block run in IEEE fp32: TF32 is switched off
    (``torch.backends.cuda.matmul.allow_tf32 = False``) when ``x`` is on a
    CUDA device, and restored after."""
    flags = torch.backends.cuda.matmul
    if not x.is_cuda or not flags.allow_tf32:
        yield
        return
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = True


def f32_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IEEE fp32 ``a @ b`` for serving-path scores and feature reductions.

    Exact ``>=`` rank ties and scores that agree with :func:`score_pairs`
    need full fp32 products, so TF32 is off for the call.
    """
    with ieee_fp32(a):
        return a @ b


def round_to_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 values to bf16, nearest even, and back to fp32: the
    operand rounding of the training path's ``fast_precision="default"``."""
    return x.bfloat16().float()


def table_rows(table: torch.Tensor, ids: torch.Tensor, placement=None) -> torch.Tensor:
    """Whole rows ``ids`` of a table: ``table[ids]``, or the table's
    ``placement.rows`` (which gathers them over the model axis when the
    table is split there)."""
    return table[ids] if placement is None else placement.rows(table, ids)


def batch_representation(
    table: torch.Tensor,  # [n_features, W]
    features,
    row_ids: torch.Tensor,  # int [...]
    scale: torch.Tensor | None = None,
    placement=None,
) -> torch.Tensor:
    """Representations for a batch of rows: ``[..., W]`` incl. bias slot.

    Identity features (or ``None``) skip the feature walk: the
    representation is the table row.  Padding slots of general features
    have weight 0 and contribute nothing.  ``scale`` is the lazy-
    regularisation accumulator; ``None`` means exactly 1.  ``placement``:
    the table's :class:`~lightfm_tpu_torch.parallel.mesh.TablePlacement`
    (None: the whole table), read through :func:`table_rows`.
    """
    row_ids = row_ids.long()
    if features is None or isinstance(features, IdentityRows):
        rows = table_rows(table, row_ids, placement)
        return rows * scale if scale is not None else rows
    if isinstance(features, ChunkedRows):
        rep = batch_representation(table, features.base, row_ids, scale, placement)
        slots = features.over_slot[row_ids].long()
        for idx_c, wts_c in zip(features.over_idx, features.over_wts):
            w = wts_c[slots]  # [..., C]; record M is all zeros (a no-op)
            if scale is not None:
                w = w * scale
            emb_c = table_rows(table, idx_c[slots].long(), placement)  # [..., C, W]
            rep = rep + _weighted_sum(w, emb_c)
        return rep

    idx = features.idx[row_ids].long()  # [..., P]
    wts = features.wts[row_ids]  # [..., P]
    if scale is not None:
        wts = wts * scale
    return _weighted_sum(wts, table_rows(table, idx, placement))


def _weighted_sum(w: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """``sum_p w[..., p] * emb[..., p, :]`` as a batched IEEE fp32 matmul."""
    return f32_dot(w[..., None, :], emb)[..., 0, :]


def with_unit_bias(user_rep: torch.Tensor) -> torch.Tensor:
    """Replace the bias slot with 1, so a full-width dot against an item
    representation yields ``dot(emb, emb) + item_bias``."""
    return torch.cat([user_rep[..., :-1], torch.ones_like(user_rep[..., -1:])], dim=-1)


def score_pairs(user_rep: torch.Tensor, item_rep: torch.Tensor) -> torch.Tensor:
    """dot(user_emb, item_emb) + user_bias + item_bias (template:320-334)."""
    return (with_unit_bias(user_rep) * item_rep).sum(-1) + user_rep[..., -1]


def full_representations(
    table: torch.Tensor,
    features,
    scale: torch.Tensor | float = 1.0,
    block: int = 8192,
) -> torch.Tensor:
    """Representations for all rows of a feature matrix, in row blocks so
    the padded gathers stay bounded for large catalogs."""
    if isinstance(features, IdentityRows):
        return table[: features.n_rows] * scale
    ids = torch.arange(features.n_rows, device=table.device)
    return torch.cat(
        [
            batch_representation(table, features, blk, scale)
            for blk in ids.split(block)
        ]
        or [table.new_zeros((0, table.shape[1]))]
    )
