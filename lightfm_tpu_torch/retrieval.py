"""Candidate retrieval: batched top-k recommendation over the full catalog.

Counterpart of ``lightfm_tpu/retrieval.py:47-370``.  Catalog scoring is
one dense ``[B, Wa] x [Wa, I]`` IEEE fp32 matmul, so exact top-k over the
whole catalog is cheap and batched:

- :func:`top_k`: exact scoring + ``torch.topk``; catalogs beyond
  ``STREAMING_CATALOG_LIMIT`` stream through item blocks (per-block top-k,
  one exact merge) so peak memory is O(B x item_block).
- :func:`top_k_sharded`: the catalog split over a mesh's model axis
  (:func:`catalog_block`), a local top-k per rank, the candidates
  all-gathered and merged;
- :class:`CompressedIndex`: two-stage scoring -- int8-quantized item rows
  give a coarse score, the top ``rerank_mult * k`` survivors are re-scored
  exactly in fp32.

No approximate top-k: the JAX package's ``method="approx"`` uses
``jax.lax.approx_max_k`` (the TPU's approximate top-k, recall target 0.95),
which has no PyTorch counterpart.  Every top-k here is the exact
``torch.topk`` (recall 1.0), so :func:`top_k` takes no ``method`` and
``LightFM.recommend`` serves its "approx" mode through it.  The same holds
for the compressed index's coarse stage.

Train-positive exclusion matches ``predict_ranks``'s masking semantics
(``_lightfm_fast.pyx.template:1303``): excluded items score -inf.

The catalog is built from the whole item table; the users' rows are read
through the user side's placement (``user_placement``; None: the state's
user table is whole), so a model whose user table is split over a mesh
serves without assembling it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from lightfm_tpu_torch.ops.ranking import (
    _catalog_representations as catalog_representations,
    _f32_dot,
    _mask_exclusions,
    pad_catalog_neg_inf as _pad_catalog,
    user_representations,
)

# Catalogs wider than this stream through item blocks.
STREAMING_CATALOG_LIMIT = 262_144


def _top_k_dense(
    u_aug: torch.Tensor,  # [B, Wa] augmented users
    item_aug: torch.Tensor,  # [I_pad, Wa] padded catalog
    exclude_idx: Optional[torch.Tensor],  # int [B, P] or None
    k: int,
):
    """Scores of the whole catalog, exclusions masked, exact top-k."""
    scores = _f32_dot(u_aug, item_aug.T)
    if exclude_idx is not None:
        _mask_exclusions(scores, exclude_idx)
    return torch.topk(scores, k, dim=1)


def _top_k_streaming(
    u_aug: torch.Tensor,
    item_aug: torch.Tensor,  # [I_pad, Wa]; I_pad % item_block == 0
    exclude_idx: Optional[torch.Tensor],
    k: int,
    item_block: int,
):
    """Blocked top-k for huge catalogs: per-block exact candidates, one
    exact merge, so the result is the global top-k."""
    cand_s, cand_i = [], []
    for b, rep in enumerate(item_aug.split(item_block)):
        start = b * item_block
        scores = _f32_dot(u_aug, rep.T)  # [B, item_block]
        if exclude_idx is not None:
            local = torch.where(
                (exclude_idx >= start) & (exclude_idx < start + item_block),
                exclude_idx - start, item_block,
            )
            _mask_exclusions(scores, local)
        s, i = torch.topk(scores, min(k, rep.shape[0]), dim=1)
        cand_s.append(s)
        cand_i.append(i + start)
    s, j = torch.topk(torch.cat(cand_s, 1), k, dim=1)
    return s, torch.cat(cand_i, 1).gather(1, j)


def build_catalog(item_table, item_feats, n_items: int, multiple: int = 128) -> torch.Tensor:
    """Padded augmented catalog of the whole ``item_table``, for repeated
    top-k serving (cacheable)."""
    return _pad_catalog(
        catalog_representations(item_table, item_feats, n_items), n_items, multiple
    )


def top_k(
    state,
    user_feats,
    item_feats,
    user_ids: torch.Tensor,
    k: int,
    n_items: int,
    exclude_idx: Optional[torch.Tensor] = None,
    catalog: Optional[torch.Tensor] = None,
    item_block: Optional[int] = None,
    user_placement=None,
):
    """Top-k items for a batch of users: ``(scores [B, k], item_ids [B, k])``.

    ``exclude_idx`` is a sentinel-padded [B, P] int array of per-user items
    to exclude (e.g. train positives), sentinel >= n_items.  Pass a prebuilt
    ``catalog`` (:func:`build_catalog`) to amortise the representation build
    across serving calls; without one, ``state.item_table`` must be whole.
    """
    u_aug = user_representations(state.user_table, user_feats, user_ids, user_placement)
    if n_items > STREAMING_CATALOG_LIMIT:
        item_block = item_block or 131_072
        item_aug = (
            catalog
            if catalog is not None and catalog.shape[0] % item_block == 0
            else build_catalog(state.item_table, item_feats, n_items, multiple=item_block)
        )
        return _top_k_streaming(u_aug, item_aug, exclude_idx, k, item_block)
    item_aug = (catalog if catalog is not None
                else build_catalog(state.item_table, item_feats, n_items))
    return _top_k_dense(u_aug, item_aug, exclude_idx, k)


def shard_rows(n_items: int, n_shards: int) -> int:
    """Catalog rows each model rank scores in :func:`top_k_sharded`; rank m
    scores items ``[m * blk, (m + 1) * blk)``.  When ``n_shards`` divides
    ``n_items`` that is the ``"rows"`` split of an item table of
    ``n_items`` rows (``parallel.mesh.plan_placement``), so a rank's own
    rows are its block; otherwise the catalog is padded to a multiple of
    ``128 * n_shards`` with rows that score -inf, as the JAX package pads it
    (``lightfm_tpu/retrieval.py:226-229``)."""
    if n_items % n_shards == 0:
        return n_items // n_shards
    return -(-n_items // (128 * n_shards)) * 128


class CatalogBlock(NamedTuple):
    """A model rank's block of the augmented catalog: items ``[start,
    start + size)``, whose rows are padded with rows that score -inf to a
    multiple of 128 (so the product has the shape :func:`top_k` gives it
    on a one-rank mesh)."""

    rows: torch.Tensor  # [round_up(size, 128), Wa]
    start: int
    size: int


def block_of(rows: torch.Tensor, start: int) -> CatalogBlock:
    """The :class:`CatalogBlock` of augmented catalog ``rows`` whose first
    item is ``start`` (a copy: what ``rows`` views can go)."""
    size = rows.shape[0]
    padded = _pad_catalog(rows, size, 128)
    return CatalogBlock(padded.clone() if padded is rows else padded, start, size)


def catalog_block(catalog: torch.Tensor, n_items: int, mesh) -> CatalogBlock:
    """This model rank's block (:func:`shard_rows`) of an augmented catalog
    of ``n_items`` rows (:func:`build_catalog`, padded or not)."""
    from lightfm_tpu_torch.parallel.mesh import MODEL_AXIS

    n_shards = mesh.shape[MODEL_AXIS]
    blk = shard_rows(n_items, n_shards)
    catalog = _pad_catalog(catalog[:n_items], n_items, blk * n_shards)
    start = mesh.coords[MODEL_AXIS] * blk
    return block_of(catalog[start:start + blk], start)


def top_k_sharded(
    state,
    user_feats,
    block: CatalogBlock,
    user_ids: torch.Tensor,
    k: int,
    mesh,
    exclude_idx: Optional[torch.Tensor] = None,
    user_placement=None,
):
    """Item-sharded top-k over a mesh's model axis
    (``lightfm_tpu/retrieval.py:201-275``).

    Model-axis rank m scores its ``block`` of the augmented catalog
    (:func:`shard_rows` gives the split, :func:`catalog_block` cuts it
    from a whole catalog, :func:`block_of` makes it of a rank's own rows)
    in IEEE fp32, masks the excluded ids that
    fall in it, and takes an exact local top-k (the JAX package's
    ``method="approx"`` is served exact here, as :func:`top_k` serves it).
    The candidates are all-gathered over the model axis and merged by one
    exact top-k, so the result is :func:`top_k`'s; communication is
    O(n_model * k) a user.  Where fewer than k items score above -inf, the
    rest of the list holds -inf scores whose ids name no item (-1), or
    excluded items.  The users' rows are read through
    ``user_placement``.  A collective: every rank of the model axis calls
    it with the same users.
    """
    from lightfm_tpu_torch.parallel.mesh import all_gather_model

    start, size = block.start, block.size
    u_aug = user_representations(state.user_table, user_feats, user_ids, user_placement)
    scores = _f32_dot(u_aug, block.rows.T)  # the pad columns score -inf
    n_cols = scores.shape[1]
    if exclude_idx is not None:
        local = torch.where(
            (exclude_idx >= start) & (exclude_idx < start + size), exclude_idx - start, n_cols,
        )
        _mask_exclusions(scores, local)
    s, i = torch.topk(scores, min(k, n_cols), dim=1)
    # A pad column is a candidate only where fewer than k of the block's
    # items score above -inf; its id must not name the next block's items.
    i = torch.where(i < size, i + start, -1)
    # [B, k] per rank -> [n_model * k, B] gathered -> [B, n_model * k].
    s_all, i_all = all_gather_model(mesh, s.T, i.T)
    sg, j = torch.topk(s_all.T, k, dim=1)
    return sg, i_all.T.gather(1, j)


class CompressedIndex(NamedTuple):
    """Int8-quantized catalog for coarse scoring + exact fp32 rerank."""

    q_items: torch.Tensor  # int8 [I_pad, Wa]
    scales: torch.Tensor  # f32 [I_pad, 1] per-item dequantization scale
    item_aug: torch.Tensor  # f32 [I_pad, Wa] exact representations
    n_items: int


def build_compressed_index(item_table, item_feats, n_items: int) -> CompressedIndex:
    """The index of the whole ``item_table``'s catalog."""
    item_aug = _pad_catalog(catalog_representations(item_table, item_feats, n_items), n_items, 128)
    # Quantize a FINITE view: the -inf pad-bias sentinel would drive the
    # per-item scale to inf; pad columns are masked by index instead.
    finite = torch.where(torch.isfinite(item_aug), item_aug, torch.zeros_like(item_aug))
    amax = finite.abs().amax(dim=1, keepdim=True).clamp(min=1e-12)
    scales = amax / 127.0
    q = torch.clamp(torch.round(finite / scales), -127, 127).to(torch.int8)
    return CompressedIndex(q, scales, item_aug, n_items)


def top_k_compressed(
    state,
    user_feats,
    index: CompressedIndex,
    user_ids: torch.Tensor,
    k: int,
    exclude_idx: Optional[torch.Tensor] = None,
    rerank_mult: int = 4,
    user_placement=None,
):
    """Two-stage top-k: int8 coarse scoring + exact fp32 rerank; the users'
    rows are read through ``user_placement``."""
    u_aug = user_representations(state.user_table, user_feats, user_ids, user_placement)
    i_pad = index.q_items.shape[0]

    # Stage 1: coarse scores against the int8 catalog, scale folded in after.
    coarse = _f32_dot(u_aug, index.q_items.T.to(torch.float32)) * index.scales[:, 0][None, :]
    # Pad columns (quantized as zeros) must never win the coarse stage.
    coarse[:, index.n_items:] = -np.inf
    if exclude_idx is not None:
        _mask_exclusions(coarse, exclude_idx)
    cs, cand = torch.topk(coarse, min(rerank_mult * k, i_pad), dim=1)

    # Stage 2: exact rerank.  Candidates whose COARSE score was -inf are
    # excluded items or padding that leaked in because fewer finite
    # candidates existed; they stay excluded.
    exact = _f32_dot(u_aug[:, None, :], index.item_aug[cand].transpose(1, 2))[:, 0]
    exact = torch.where(
        (cand < index.n_items) & torch.isfinite(cs), exact,
        torch.full_like(exact, -np.inf),
    )
    s, j = torch.topk(exact, k, dim=1)
    return s, cand.gather(1, j)
