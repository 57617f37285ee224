"""Epoch runner: synchronous batched SGD over shuffled interactions.

Counterpart of ``lightfm_tpu/train.py``.  The training set is staged once
on the device as a packed int32 ``[8, n_pad]`` block plus, for the ranking
losses, sorted per-user positives; every epoch then runs on the device.
Only the fast path (:mod:`lightfm_tpu_torch.fast_warp`) is ported: the
generic path (``train._epoch``'s non-fast branch, ``losses.py``'s steps,
``ops/updates.py``) is ROADMAP.md item 3 and raises here.

Each epoch's random draws come from a ``torch.Generator`` on the device
seeded with that epoch's seed (one per epoch, drawn by the model from its
numpy ``RandomState``), so seeded fits are deterministic.  The numbers
differ from ``jax.random``'s; the tests feed both packages the same draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from lightfm_tpu_torch.config import Hyperparams
from lightfm_tpu_torch.sparse import PaddedSortedRows
from lightfm_tpu_torch.state import ModelState


class TrainData(NamedTuple):
    """Device-resident training set (padded to a whole number of batches).

    ``packed`` int32 [8, n_pad]: rows 0 = user id, 1 = item id, 2 = value
    bits, 3 = weight bits (float32 bit patterns), 4 = valid flag, 5-7 zero
    pad -- the JAX package's layout, bitwise.  ``user_feats``/``item_feats``
    are :class:`IdentityRows` or, for a hybrid fit, padded feature matrices
    already on the device.
    """

    packed: torch.Tensor
    user_feats: object  # IdentityRows | PaddedRows
    item_feats: object
    # Sorted per-user positives for negative-sample rejection (ranking losses).
    positives: Optional[PaddedSortedRows]
    # Item column of every training interaction: BPR's empirical negative
    # distribution (template:1123-1127).  None for other losses.
    train_items: Optional[torch.Tensor]
    # Transposed feature lists (fast_warp.TransposedFeats) for the hybrid
    # path's aggregated update; None for identity sides or when the model
    # does not stage them (then feature updates run as scatters).
    user_feats_T: Optional[object] = None
    item_feats_T: Optional[object] = None


def choose_batch_size(n_examples: int, requested: Optional[int]) -> int:
    """Heuristic batch size (``lightfm_tpu/train.py:67-90``): ~n/64 (min
    1024, a power of two) on small data; beyond 2^19 examples ~n/40 up to
    131072, keeping >= 40 optimizer steps per epoch where the large-batch
    accuracy floors were calibrated."""
    if requested is not None:
        return int(requested)
    cap = 8192 if n_examples <= (1 << 19) else min(131072, n_examples // 40)
    target = max(1024, min(cap, n_examples // 64))
    b = 1 << (int(target) - 1).bit_length()
    if n_examples > (1 << 19) and n_examples // b < 40:
        b >>= 1
    return b


def _float_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def pack_on_device(row, col, vals, wts, n_pad: int) -> torch.Tensor:
    """The [8, n_pad] packed block from raw COO columns on their device.
    ``vals``/``wts`` may be Python floats (a constant column is made on the
    device instead of crossing the host link)."""
    n = row.shape[0]
    dev = row.device

    def bits(x):
        if not isinstance(x, torch.Tensor):
            x = torch.full((n,), x, dtype=torch.float32, device=dev)
        return _float_bits(x)

    out = torch.zeros((8, n_pad), dtype=torch.int32, device=dev)
    out[0, :n] = row
    out[1, :n] = col
    out[2, :n] = bits(vals)
    out[3, :n] = bits(wts)
    out[4, :n] = 1  # valid flag
    return out


def positives_on_device(row, col, n_users: int, n_items: int, width: int) -> PaddedSortedRows:
    """:class:`PaddedSortedRows` built on the device from raw COO columns:
    per-row sorted unique columns, sentinel ``n_items`` padding, lengths
    clipped to ``width`` -- ``lightfm_tpu/train.py:115-141``, bitwise."""
    dev = row.device
    key = (row.to(torch.int64) << 32) | col.to(torch.int64)
    skey, _ = torch.sort(key)
    srow = skey >> 32
    scol = (skey & 0xFFFFFFFF).to(torch.int32)
    keep = torch.ones_like(skey, dtype=torch.bool)
    keep[1:] = skey[1:] != skey[:-1]
    ones = keep.to(torch.int64)
    kept_rank = torch.cumsum(ones, 0) - ones
    lengths = torch.zeros(n_users, dtype=torch.int64, device=dev)
    lengths.index_add_(0, srow, ones)  # integer sums: order-free
    row_start = torch.cumsum(lengths, 0) - lengths
    pos = kept_rank - row_start[srow]
    # Duplicates and over-width tails land in a spare column, then dropped.
    pos = torch.where(keep & (pos < width), pos, torch.full_like(pos, width))
    idx = torch.full((n_users, width + 1), n_items, dtype=torch.int32, device=dev)
    idx[srow, pos] = scol
    return PaddedSortedRows(
        idx[:, :width].contiguous(),
        torch.clamp(lengths, max=width).to(torch.int32),
        n_items,
    )


def build_train_data(
    interactions_coo,
    sample_weight_data: np.ndarray,
    user_feats,
    item_feats,
    hp: Hyperparams,
    batch_size: int,
    device,
) -> TrainData:
    """Stage the COO training set on ``device``, padded to whole batches.
    Only the raw COO columns cross the host link (values and weights only
    when not constant); the packed block and the positives are built on
    the device."""
    n = len(interactions_coo.data)
    n_pad = max(1, -(-n // batch_size)) * batch_size
    n_users, n_items = interactions_coo.shape

    row = np.ascontiguousarray(interactions_coo.row, dtype=np.int32)
    col = np.ascontiguousarray(interactions_coo.col, dtype=np.int32)
    vals = np.asarray(interactions_coo.data, dtype=np.float32)
    wts = np.asarray(sample_weight_data, dtype=np.float32)
    vconst = float(vals[0]) if n and (vals == vals[0]).all() else None
    wconst = float(wts[0]) if n and (wts == wts[0]).all() else None

    drow = torch.from_numpy(row).to(device)
    dcol = torch.from_numpy(col).to(device)
    packed = pack_on_device(
        drow,
        dcol,
        vconst if vconst is not None else torch.from_numpy(vals).to(device),
        wconst if wconst is not None else torch.from_numpy(wts).to(device),
        n_pad,
    )

    positives = None
    train_items = None
    if hp.loss in ("warp", "bpr", "warp-kos"):
        # warp/bpr only REJECT against this structure, where a width cap is
        # statistically safe; k-OS samples from it and needs full rows.
        lengths = np.bincount(row, minlength=n_users) if n else np.zeros(n_users, np.int64)
        width = int(lengths.max()) if n else 1  # dup-inclusive upper bound
        if hp.loss != "warp-kos":
            width = min(width, 512)
        width = max(8 * -(-width // 8), 8)
        positives = positives_on_device(drow, dcol, n_users, n_items, width)
    if hp.loss == "bpr":
        train_items = dcol

    return TrainData(
        packed=packed,
        user_feats=user_feats,
        item_feats=item_feats,
        positives=positives,
        train_items=train_items,
    )


def _generic_path_error(hp: Hyperparams) -> NotImplementedError:
    return NotImplementedError(
        f"lightfm_tpu_torch trains only on the fast path (loss warp, bpr or "
        f"logistic; adagrad; item_alpha = user_alpha = 0; identity features, or "
        f"for warp and bpr feature matrices of at most 16 padded entries per row; "
        f"an item table of at least 2^19 elements; fast_path 'on', or 'auto' "
        f"on a CUDA device); this configuration (loss={hp.loss!r}, "
        f"learning_schedule={hp.learning_schedule!r}, fast_path={hp.fast_path!r}) "
        f"needs the generic path, which is not ported yet (ROADMAP.md, item 3)"
    )


def _no_op(hp: Hyperparams) -> bool:
    # Post-construction `model.max_sampled = 0`: the reference's sampling
    # loop never runs, so every WARP epoch is an exact no-op
    # (`tests/test_movielens.py:247-263`).
    return hp.max_sampled == 0 and hp.loss in ("warp", "warp-kos")


def _epoch(state, data, seed: int, hp, batch_size, fast):
    if not fast:
        raise _generic_path_error(hp)
    from lightfm_tpu_torch import fast_warp

    gen = torch.Generator(device=data.packed.device).manual_seed(int(seed))
    draws = fast_warp.draw_epoch(gen, data, hp, batch_size)
    return fast_warp.fast_epoch(state, data, draws, hp, batch_size)


def run_epochs(state: ModelState, data: TrainData, seeds, hp: Hyperparams,
               batch_size: int, fast=False) -> ModelState:
    """One epoch per seed in ``seeds`` (uint32 values, one per epoch from
    the model's RandomState).  Returns a new state; the caller's tensors
    are left as they were (the fast path updates a copy in place)."""
    if _no_op(hp) or len(seeds) == 0:
        return state
    state = ModelState(*(x.clone() for x in state))
    for seed in seeds:
        state = _epoch(state, data, int(seed), hp, batch_size, fast)
    return state


def run_epoch(state: ModelState, data: TrainData, seed: int, hp: Hyperparams,
              batch_size: int, fast=False) -> ModelState:
    """One epoch seeded by ``seed`` (the verbose per-epoch fit loop)."""
    return run_epochs(state, data, [seed], hp, batch_size, fast)
