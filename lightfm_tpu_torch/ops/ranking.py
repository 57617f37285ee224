"""Catalog ranking: the port's ``predict_ranks``.

Counterpart of ``lightfm_tpu/ops/ranking.py:46-623``.  For every test
interaction, count catalog items (train positives excluded) whose score is
``>=`` the test item's score -- the reference's pessimistic ties
(``_lightfm_fast.pyx.template:1303-1318``).  Scores ride one matmul per
user block through augmented representations: ``u' = [u_emb, 1, u_bias]``
and ``i' = [i_emb, i_bias, 1]`` give ``u'.i' = dot + u_bias + i_bias``;
with the fused tables (W = table_width(D) columns, bias last) both are
``Wa = W + 1`` wide.

Three paths, dispatched per degree tier in :func:`predict_ranks_padded`:

- :func:`_ranks_fused`: tensors on a CUDA device and at most
  ``COUNT_T_LIMIT`` test items per user.  The hand-written kernels of
  :mod:`lightfm_tpu_torch.ops.rank_counts` count without materialising
  scores; test and excluded-item scores come from ``pair_scores``, bitwise
  equal to the counting kernel's own, so the self match is removed by an
  exact ``- 1``.  On the CPU the same function runs the plain versions.
- :func:`_ranks_flat` / :func:`_ranks_blocked`: plain torch (``torch.matmul``,
  ``torch.sort``, ``torch.searchsorted``) for wide tiers, on any device;
  the test scores are read from the very score rows that are counted.

Every matmul here is IEEE fp32 (``f32_dot`` turns TF32 off around it).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from lightfm_tpu_torch.ops.rank_counts import MAX_T, pair_scores, rank_counts
from lightfm_tpu_torch.ops.representation import (
    batch_representation,
    f32_dot as _f32_dot,
    full_representations,
)
from lightfm_tpu_torch.sparse import IdentityRows, content_fingerprint, trim_rows
from lightfm_tpu_torch.state import ModelState

# Above this catalog width the flat [user_block, n_items] score row is
# replaced by the blocked two-pass variant.
FLAT_CATALOG_LIMIT = 131072

# With at most this many test items per user, ranks are counted by direct
# comparison -- on the card by the rank_counts kernel, whose per-thread
# counts live in registers up to this width; above it sort + binary search.
COUNT_T_LIMIT = MAX_T

# Elements of the [U, T, chunk] compare mask in _ranks_fused's train-
# exclusion loop; the chunk width is chosen to stay within it.
_EXCL_MASK_BUDGET = 256 << 20

# How often _ranks_fused's clamp at zero changed a rank.  The kernels (and,
# on the CPU, the plain versions) score a test item bitwise as its catalog
# row, so the self match counts exactly once and this stays 0.
stats = {"clamped": 0}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _count_geq(scores: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """counts[u, t] = #{i : scores[u, i] >= ts[u, t]}, item-blocked so the
    [UB, T, IB] compare stays bounded."""
    counts = torch.zeros(ts.shape, dtype=torch.int64, device=ts.device)
    for sb in scores.split(8192, dim=1):
        counts += (sb[:, None, :] >= ts[:, :, None]).sum(-1)
    return counts


def _rank_counts(scores: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Per test score, how many catalog scores are >= it (pessimistic ties)."""
    if ts.shape[-1] <= COUNT_T_LIMIT:
        return _count_geq(scores, ts).to(torch.float32)
    sorted_scores = torch.sort(scores, dim=-1).values
    pos = torch.searchsorted(sorted_scores, ts.contiguous(), side="left")
    return (scores.shape[-1] - pos).to(torch.float32)


def _augment_users(u_rep: torch.Tensor) -> torch.Tensor:
    """[.., W] -> [.., W+1]: [emb, 1, bias]."""
    d = u_rep.shape[-1] - 1
    ones = torch.ones(u_rep.shape[:-1] + (1,), dtype=u_rep.dtype, device=u_rep.device)
    return torch.cat([u_rep[..., :d], ones, u_rep[..., d:]], dim=-1)


def _augment_items(i_rep: torch.Tensor) -> torch.Tensor:
    """[.., W] -> [.., W+1]: [emb, bias, 1]."""
    ones = torch.ones(i_rep.shape[:-1] + (1,), dtype=i_rep.dtype, device=i_rep.device)
    return torch.cat([i_rep, ones], dim=-1)


def pad_catalog_neg_inf(item_aug: torch.Tensor, n_items: int, multiple: int) -> torch.Tensor:
    """Pad catalog rows to ``multiple`` with rows that score -inf (bias col)."""
    pad_rows = _round_up(n_items, multiple) - item_aug.shape[0]
    if pad_rows <= 0:
        return item_aug
    pad_block = item_aug.new_zeros((pad_rows, item_aug.shape[1]))
    pad_block[:, -2] = -np.inf
    return torch.cat([item_aug, pad_block], dim=0)


def _catalog_representations(state, item_feats, n_items: int) -> torch.Tensor:
    """Augmented representations for catalog rows [0, n_items) (the test
    matrix's column count, template:1301)."""
    if isinstance(item_feats, IdentityRows):
        rep = state.item_table[:n_items]
    else:
        rep = full_representations(state.item_table, trim_rows(item_feats, n_items))
    return _augment_items(rep).contiguous()


def _mask_exclusions(scores: torch.Tensor, exclude_idx: torch.Tensor) -> torch.Tensor:
    """Set ``scores[u, exclude_idx[u, p]]`` to -inf in place; indices at or
    past the last column are sentinels and change nothing.  ``amin`` with
    +inf for sentinels keeps duplicate indices deterministic."""
    n_cols = scores.shape[1]
    src = torch.full(exclude_idx.shape, np.inf, device=scores.device)
    src.masked_fill_(exclude_idx < n_cols, -np.inf)
    idx = exclude_idx.clamp(0, n_cols - 1).long()
    return scores.scatter_reduce_(1, idx, src, reduce="amin")


def _user_blocks(user_ids, test_idx, test_valid, train_idx, user_block: int):
    return zip(
        user_ids.split(user_block), test_idx.split(user_block),
        test_valid.split(user_block), train_idx.split(user_block),
    )


def _ranks_flat(
    state: ModelState,
    user_feats,
    item_feats,
    user_ids: torch.Tensor,  # int32 [Upad]
    test_idx: torch.Tensor,  # int32 [Upad, T]
    test_valid: torch.Tensor,  # bool [Upad, T]
    train_idx: torch.Tensor,  # int32 [Upad, Ptr] (sentinel >= n_items)
    n_items: int,
    user_block: int,
) -> torch.Tensor:
    item_aug = pad_catalog_neg_inf(
        _catalog_representations(state, item_feats, n_items), n_items, 128
    )
    out = []
    for u_ids, t_idx, t_valid, tr_idx in _user_blocks(
        user_ids, test_idx, test_valid, train_idx, user_block
    ):
        u_aug = _augment_users(batch_representation(state.user_table, user_feats, u_ids))
        scores = _f32_dot(u_aug, item_aug.T)
        # Exclude train positives (template:1303).
        scores = _mask_exclusions(scores, tr_idx)
        # Test scores come from the SAME score row -> exact tie handling.
        ts = scores.gather(1, t_idx.long())
        counts = _rank_counts(scores, ts)
        # The self match always counts exactly once (template:1318).
        out.append(torch.where(t_valid, counts - 1.0, torch.zeros_like(counts)))
    return torch.cat(out)


def _ranks_blocked(
    state: ModelState,
    user_feats,
    item_feats,
    user_ids: torch.Tensor,
    test_idx: torch.Tensor,
    test_valid: torch.Tensor,
    train_idx: torch.Tensor,
    n_items: int,
    user_block: int,
    item_block: int,
) -> torch.Tensor:
    """Two-pass blocked variant for very large catalogs.

    Pass 1 extracts each test item's score from the block matmul holding
    it; pass 2 re-runs the same block matmuls to count.  Identical shapes
    give identical floats, so tie handling stays exact.
    """
    item_aug = pad_catalog_neg_inf(
        _catalog_representations(state, item_feats, n_items), n_items, item_block
    )
    blocks = item_aug.split(item_block)
    out = []
    for u_ids, t_idx, t_valid, tr_idx in _user_blocks(
        user_ids, test_idx, test_valid, train_idx, user_block
    ):
        u_aug = _augment_users(batch_representation(state.user_table, user_feats, u_ids))
        t_idx = t_idx.long()

        def block_scores(b, rep):
            start = b * item_block
            local = torch.where(
                (tr_idx >= start) & (tr_idx < start + item_block),
                tr_idx - start, item_block,
            )
            return _mask_exclusions(_f32_dot(u_aug, rep.T), local)

        ts = torch.full(t_idx.shape, np.inf, dtype=torch.float32, device=u_aug.device)
        for b, rep in enumerate(blocks):
            start = b * item_block
            in_blk = (t_idx >= start) & (t_idx < start + item_block)
            local_t = torch.where(in_blk, t_idx - start, 0)
            ts = torch.where(in_blk, block_scores(b, rep).gather(1, local_t), ts)
        ts = torch.where(t_valid, ts, torch.full_like(ts, np.inf))

        counts = torch.zeros_like(ts)
        for b, rep in enumerate(blocks):
            counts += _rank_counts(block_scores(b, rep), ts)
        out.append(torch.where(t_valid, counts - 1.0, torch.zeros_like(counts)))
    return torch.cat(out)


def _ranks_fused(
    state: ModelState,
    user_feats,
    item_feats,
    user_ids: torch.Tensor,  # int32 [Upad]
    test_idx: torch.Tensor,  # int32 [Upad, T]
    test_valid: torch.Tensor,  # bool [Upad, T]
    train_idx: torch.Tensor,  # int32 [Upad, Ptr] (sentinel >= n_items)
    n_items: int,
    item_block: int,
) -> torch.Tensor:
    """Kernel-fused ranking: catalog scores never reach device memory.

    rank[u, t] = #{catalog i: s_i >= ts_t} - #{train-excluded j: s_j >= ts_t}
    - 1 (the self match).  Test and excluded-item scores come from
    ``pair_scores``, bitwise equal to ``rank_counts``'s own on the card.

    Unlike the JAX package, the excluded scores need no [U, chunk, Wa]
    gather (``pair_scores`` reads catalog rows in place), so that gather's
    budget is gone; the chunk width is instead budgeted on the [U, T, chunk]
    compare mask (``_EXCL_MASK_BUDGET`` elements).
    """
    # ALWAYS pad at least one row: the exclusion sentinel below points at
    # i_pad - 1, which must be a -inf pad row, not a real item.
    item_aug = pad_catalog_neg_inf(
        _catalog_representations(state, item_feats, n_items), n_items + 1, item_block
    )
    i_pad = item_aug.shape[0]
    u_aug = _augment_users(
        batch_representation(state.user_table, user_feats, user_ids)
    ).contiguous()

    # Invalid test slots get ts = +inf, so they count 0.
    safe_t = test_idx.clamp(max=i_pad - 1).int().contiguous()
    ts = pair_scores(u_aug, item_aug, safe_t)
    ts = torch.where(test_valid, ts, torch.full_like(ts, np.inf)).contiguous()
    counts = rank_counts(u_aug, item_aug, ts)

    # Train-positive exclusion: subtract excluded items scoring >= ts.
    # Sentinels hit -inf pad rows and never count.
    U, T = ts.shape
    Ptr = train_idx.shape[1]
    chunk = min(_round_up(Ptr, 32), max(32, _EXCL_MASK_BUDGET // max(1, U * T) // 32 * 32))
    tr = train_idx.clamp(max=i_pad - 1).int()
    excl = torch.zeros((U, T), dtype=torch.int64, device=ts.device)
    for tr_c in tr.split(chunk, dim=1):
        s_c = pair_scores(u_aug, item_aug, tr_c.contiguous())  # [U, chunk]
        excl += (s_c[:, None, :] >= ts[:, :, None]).sum(-1)

    raw = counts - excl.to(torch.float32) - 1.0
    stats["clamped"] += int(((raw < 0) & test_valid).sum())
    return torch.where(test_valid, raw.clamp(min=0.0), torch.zeros_like(raw))


class _RankTier:
    """Host-prepared inputs for one degree tier of test users.

    ``user_ids`` are the ORIGINAL user ids ranked in this tier; ``nnz_pos``
    maps the tier's (local row, slot) extraction back into the test CSR's
    data order.
    """

    __slots__ = (
        "user_ids", "test_idx", "test_valid", "train_idx",
        "row_of", "pos_in_row", "nnz_pos",
    )

    def __init__(self, user_ids, test_idx, test_valid, train_idx,
                 row_of, pos_in_row, nnz_pos):
        self.user_ids = user_ids
        self.test_idx = test_idx
        self.test_valid = test_valid
        self.train_idx = train_idx
        self.row_of = row_of
        self.pos_in_row = pos_in_row
        self.nnz_pos = nnz_pos


def _split_degree_tiers(tr_lengths: np.ndarray, users: np.ndarray):
    """Partition ``users`` into train-degree tiers: users above ~4x the
    rounded p99 degree go to a separate tier that pays the wide exclusion
    padding only for itself."""
    if len(users) == 0:
        return [users]
    deg = tr_lengths[users]
    # method="lower" keeps a lone outlier's own degree out of the p99.
    p99 = int(np.percentile(deg, 99, method="lower")) if len(deg) else 0
    cap = max(8 * ((p99 + 7) // 8), 64)
    if int(deg.max()) <= 4 * cap:
        return [users]
    heavy = deg > cap
    return [users[~heavy], users[heavy]]


def _ragged_positions(indptr: np.ndarray, users: np.ndarray):
    """(flat CSR positions, local row, slot in row) of the listed rows."""
    lengths = np.diff(indptr)[users]
    offsets = np.repeat(np.cumsum(lengths) - lengths, lengths)
    slot = np.arange(int(lengths.sum())) - offsets
    flat = np.repeat(indptr[users], lengths) + slot
    return flat, np.repeat(np.arange(len(users)), lengths), slot


def _build_tier(test_csr, train_csr, users: np.ndarray, user_block: int, device):
    """Padded blocks for one tier (tensors built once, cacheable)."""
    n_items = test_csr.shape[1]
    lengths = np.diff(test_csr.indptr)[users]
    T = max(1, int(lengths.max()))
    u_pad = _round_up(len(users), min(user_block, max(8, _round_up(len(users), 8))))

    nnz_pos, row_of, pos_in_row = _ragged_positions(test_csr.indptr, users)
    test_idx = np.zeros((u_pad, T), dtype=np.int32)
    test_valid = np.zeros((u_pad, T), dtype=bool)
    test_idx[row_of, pos_in_row] = test_csr.indices[nnz_pos].astype(np.int32)
    test_valid[row_of, pos_in_row] = True

    tr_lengths = np.diff(train_csr.indptr)[users]
    Ptr = max(1, int(tr_lengths.max()) if len(tr_lengths) else 1)
    train_idx = np.full((u_pad, Ptr), n_items, dtype=np.int32)
    if tr_lengths.sum():
        tnnz, trow_of, tpos = _ragged_positions(train_csr.indptr, users)
        train_idx[trow_of, tpos] = train_csr.indices[tnnz].astype(np.int32)

    user_ids = np.zeros(u_pad, dtype=np.int32)
    user_ids[: len(users)] = users

    def put(a):
        return torch.from_numpy(a).to(device)

    return _RankTier(
        put(user_ids), put(test_idx), put(test_valid), put(train_idx),
        row_of, pos_in_row, nnz_pos,
    )


def _prepare_rank_tiers(test_csr, train_csr, user_block: int, device, cache=None):
    """Tiered, device-staged rank inputs, memoized across metric calls.

    The cache key is the IDENTITY of the test/train matrices (weakref-
    guarded against id reuse) plus shape/nnz and a content checksum, so the
    per-epoch metric loop skips host padding and host->device copies after
    the first call, and in-place mutation misses instead of going stale.
    """
    key = None
    if cache is not None:
        key = (
            "rank_prep", id(test_csr), id(train_csr),
            test_csr.shape, test_csr.nnz, train_csr.nnz, user_block, str(device),
            content_fingerprint(test_csr), content_fingerprint(train_csr),
        )
        hit = cache.get(key)
        if hit is not None:
            ref_t, ref_tr, tiers = hit
            if ref_t() is test_csr and ref_tr() is train_csr:
                return tiers
    # Only users WITH test interactions are ranked (template:1232-1323).
    users = np.flatnonzero(np.diff(test_csr.indptr) > 0)
    tr_lengths = np.diff(train_csr.indptr)
    tiers = [
        _build_tier(test_csr, train_csr, tier_users, user_block, device)
        for tier_users in _split_degree_tiers(tr_lengths, users)
        if len(tier_users)
    ]
    if cache is not None:
        # Evict entries for the same matrices with a stale checksum, and
        # entries whose matrices are gone (they would pin device tiers).
        for k in [
            k for k, v in cache.items()
            if (isinstance(k, tuple) and k[:3] == key[:3] and k != key)
            or (
                isinstance(k, tuple) and k and k[0] == "rank_prep"
                and isinstance(v, tuple) and len(v) == 3
                and isinstance(v[0], weakref.ref)
                and (v[0]() is None or v[1]() is None)
            )
        ]:
            del cache[k]
        cache[key] = (weakref.ref(test_csr), weakref.ref(train_csr), tiers)
        # Cap live entries too; insertion order = age.
        prep_keys = [
            k for k in cache if isinstance(k, tuple) and k and k[0] == "rank_prep"
        ]
        for k in prep_keys[: max(0, len(prep_keys) - 16)]:
            del cache[k]
    return tiers


def predict_ranks_padded(
    state: ModelState,
    user_feats,
    item_feats,
    test_csr,
    train_csr,
    user_block: int = 256,
    item_block: int = 8192,
    cache=None,
) -> np.ndarray:
    """Ranks for every nnz of ``test_csr``, aligned with the CSR's data
    array (the layout the reference writes, `lightfm/lightfm.py:968-985`).

    Users are processed in train-degree tiers, and the host prep is
    memoized in ``cache`` when given (see :func:`_prepare_rank_tiers`).
    """
    n_users, n_items = test_csr.shape
    if test_csr.nnz == 0:
        return np.zeros(0, dtype=np.float32)

    device = state.user_table.device
    out = np.empty(test_csr.nnz, dtype=np.float32)
    for tier in _prepare_rank_tiers(test_csr, train_csr, user_block, device, cache):
        T = tier.test_idx.shape[1]
        ub = int(min(user_block, tier.user_ids.shape[0]))
        args = (
            state, user_feats, item_feats,
            tier.user_ids, tier.test_idx, tier.test_valid, tier.train_idx,
        )
        if T <= COUNT_T_LIMIT and device.type == "cuda":
            # Kernel-fused path: scores never reach device memory; any
            # catalog size.
            ranks = _ranks_fused(*args, n_items=int(n_items), item_block=2048)
        elif n_items <= FLAT_CATALOG_LIMIT:
            ranks = _ranks_flat(*args, n_items=int(n_items), user_block=ub)
        else:
            ranks = _ranks_blocked(
                *args, n_items=int(n_items), user_block=ub, item_block=int(item_block),
            )
        ranks = ranks.cpu().numpy()
        out[tier.nnz_pos] = ranks[tier.row_of, tier.pos_in_row]
    return out
