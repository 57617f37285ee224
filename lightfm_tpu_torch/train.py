"""Epoch runner: synchronous batched SGD over shuffled interactions.

Counterpart of ``lightfm_tpu/train.py``.  The training set is staged once
on the device as a packed int32 ``[8, n_pad]`` block plus, for the ranking
losses, sorted per-user positives; every epoch then runs on the device,
on one of two paths:

- the fast path (:mod:`lightfm_tpu_torch.fast_warp`), where
  ``fast_warp_eligible`` lets it run;
- the generic path (the non-fast branch of ``lightfm_tpu/train.py``'s
  ``_epoch``): a global shuffle (:func:`_shuffle_global`), then one step
  of :data:`lightfm_tpu_torch.losses.LOSS_STEPS` per batch, with the
  lazy-L2 fold after each step and at the epoch's end.  It trains every
  loss, both schedules, L2 and any feature layout, in plain PyTorch.

Under a device mesh (``mesh``, :mod:`lightfm_tpu_torch.parallel`) both
paths run data-parallel: every rank draws the same epoch and steps over its
data coordinate's columns of every batch, the steps all-gather what the
update needs, and every rank applies the same update.  The generic path
also takes example-sharded input (``TrainData.examples_sharded``) and the
stratified local shuffle (:func:`_shuffle_local_slice`, ``shuffle="local"``),
and tables split over the model axis by rows or components (``placement``,
:func:`lightfm_tpu_torch.parallel.mesh.plan_placement`): its steps gather
the rows they read and apply the touches of the part each rank holds.

Each epoch's random draws come from a ``torch.Generator`` on the device
seeded with that epoch's seed (one per epoch, drawn by the model from its
numpy ``RandomState``), so seeded fits are deterministic.  The numbers
differ from ``jax.random``'s; the tests feed both packages the same draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from lightfm_tpu_torch import observability
from lightfm_tpu_torch.config import Hyperparams
from lightfm_tpu_torch.losses import LOSS_STEPS, _lazy_reg, kos_slots
from lightfm_tpu_torch.sparse import PaddedSortedRows
from lightfm_tpu_torch.state import ModelState, fold_scales, maybe_fold_scales


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
    # Under a mesh with ``shard_examples``: ``packed`` holds only this
    # rank's [8, n_pad / n_data] column slice (parallel.shard_train_data).
    examples_sharded: bool = False


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


def build_positives(row: np.ndarray, col: np.ndarray, shape, loss: str, device,
                    drow=None, dcol=None) -> PaddedSortedRows:
    """The per-user positives of the COO columns ``row``/``col`` on
    ``device`` (``drow``/``dcol``: the same columns already there).
    warp/bpr only REJECT against this structure, where a width cap of 512
    is statistically safe; k-OS samples from it and needs full rows."""
    n_users, n_items = shape
    n = len(row)
    lengths = np.bincount(row, minlength=n_users) if n else np.zeros(n_users, np.int64)
    width = int(lengths.max()) if n else 1  # dup-inclusive upper bound
    if loss != "warp-kos":
        width = min(width, 512)
    width = max(8 * -(-width // 8), 8)
    if drow is None:
        drow = torch.from_numpy(np.ascontiguousarray(row, dtype=np.int32)).to(device)
        dcol = torch.from_numpy(np.ascontiguousarray(col, dtype=np.int32)).to(device)
    return positives_on_device(drow, dcol, n_users, n_items, width)


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
        positives = build_positives(row, col, (n_users, n_items), hp.loss, device,
                                    drow=drow, dcol=dcol)
    if hp.loss == "bpr":
        train_items = dcol

    return TrainData(
        packed=packed,
        user_feats=user_feats,
        item_feats=item_feats,
        positives=positives,
        train_items=train_items,
    )


def _shuffle_global(packed: torch.Tensor, keys: torch.Tensor, n_batches: int,
                    batch_size: int) -> torch.Tensor:
    """Global per-epoch permutation (``lightfm_tpu/train.py:208-220``): a
    stable sort by one random u32 key per example (held as int64) carrying
    the 8 packed rows, cut into ``[n_batches, 8, B]``.  Bitwise the JAX
    package's given the same keys (ties keep their order in both)."""
    order = torch.sort(keys, stable=True).indices
    return packed[:, order].reshape(8, n_batches, batch_size).transpose(0, 1)


def _shuffle_local_slice(local: torch.Tensor, keys: torch.Tensor, n_batches: int) -> torch.Tensor:
    """Stratified per-epoch shuffle for example-sharded input
    (``lightfm_tpu/train.py:221-255``), one data coordinate's part: a stable
    sort of its ``[8, n_local]`` slice by its ``n_local`` u32 keys (int64),
    cut into ``[n_batches, 8, n_local / n_batches]``, its contiguous columns
    of every global batch.  Every example still appears once per epoch,
    every batch mixes all slices, and no exchange is needed; bitwise the
    JAX package's block given the same ``[n_data, n_local]`` keys."""
    order = torch.sort(keys, stable=True).indices
    return local[:, order].reshape(8, n_batches, -1).transpose(0, 1)


class GenericDraws(NamedTuple):
    """One generic epoch's random draws.

    ``perm``: [n_pad] u32 sort keys (int64).  ``neg``: [n_batches, K, B]
    negative item ids (WARP, k-OS).  ``tries``: [n_batches, B, T] positions
    into ``train_items`` (BPR).  ``kos_u``: [n_batches, n, B] uniforms in
    [0, 1) that become each example's positive slots once its batch is
    known (:func:`lightfm_tpu_torch.losses.kos_slots`).  Fields a loss does
    not use are None.
    """

    perm: torch.Tensor
    neg: Optional[torch.Tensor] = None
    tries: Optional[torch.Tensor] = None
    kos_u: Optional[torch.Tensor] = None


@observability.spanned("epoch.draws")
def draw_generic_epoch(gen: torch.Generator, data: TrainData, hp: Hyperparams,
                       batch_size: int, mesh=None) -> GenericDraws:
    """Draw one generic epoch's :class:`GenericDraws` from ``gen`` on its
    device: the whole epoch's, also on a rank of a ``mesh`` that holds only
    its slice of the examples."""
    dev = gen.device
    n_pad = data.packed.shape[1]
    if data.examples_sharded:
        n_pad *= mesh.shape["data"]
    n_batches = n_pad // batch_size
    perm = torch.randint(0, 1 << 32, (n_pad,), generator=gen, device=dev, dtype=torch.int64)
    neg = tries = kos_u = None
    if hp.loss == "bpr":
        n_ex = data.train_items.shape[0]
        tries = torch.randint(0, n_ex, (n_batches, batch_size, hp.bpr_tries), generator=gen,
                              device=dev)
    if hp.loss == "warp-kos":
        kos_u = torch.rand((n_batches, hp.n, batch_size), generator=gen, device=dev)
    if hp.loss in ("warp", "warp-kos"):
        neg = torch.randint(0, data.item_feats.n_rows, (n_batches, hp.max_sampled, batch_size),
                            generator=gen, device=dev)
    return GenericDraws(perm, neg, tries, kos_u)


def _step_draws(draws: GenericDraws, b: int, batch, positives, hp: Hyperparams,
                cols=slice(None)):
    """Step ``b``'s draws for the batch columns ``cols`` (a rank's slice)."""
    if hp.loss == "warp":
        return draws.neg[b][:, cols]
    if hp.loss == "bpr":
        return draws.tries[b][cols]
    if hp.loss == "warp-kos":
        lens = positives.lengths[batch.user_ids.long()]
        return kos_slots(draws.kos_u[b][:, cols], lens), draws.neg[b][:, cols]
    return None


@observability.spanned("epoch.shuffle")
def _epoch_batches(data: TrainData, draws: GenericDraws, batch_size: int, mesh, shuffle: str):
    """This rank's ``[n_batches, 8, B_local]`` shuffled batches and its
    column slice of every batch.  No mesh: the global shuffle, whole
    batches.  A mesh: the global shuffle over the whole block (all-gathered
    once when the examples are sharded), or the local shuffle of the rank's
    own slice; either way the rank keeps its data coordinate's columns."""
    from lightfm_tpu_torch.parallel.mesh import DATA_AXIS, all_gather_rows, shard_columns

    n_local = data.packed.shape[1]
    if mesh is None:
        n_batches = n_local // batch_size
        return _shuffle_global(data.packed, draws.perm, n_batches, batch_size), slice(None)
    n_data, d = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
    n_pad = n_local * n_data if data.examples_sharded else n_local
    n_batches = n_pad // batch_size
    if batch_size % n_data:
        raise ValueError(f"batch_size ({batch_size}) must divide the data axis ({n_data})")
    b_local = batch_size // n_data
    cols = slice(d * b_local, (d + 1) * b_local)
    if shuffle == "local":
        local = data.packed if data.examples_sharded else shard_columns(data.packed, mesh)
        keys = draws.perm.reshape(n_data, -1)[d]
        return _shuffle_local_slice(local, keys, n_batches), cols
    packed = data.packed
    if data.examples_sharded:
        # The exchange XLA inserts for a sort over a sharded axis.
        packed = all_gather_rows(mesh, packed.T)[0].T
    return _shuffle_global(packed, draws.perm, n_batches, batch_size)[:, :, cols], cols


def generic_epoch(state: ModelState, data: TrainData, draws: GenericDraws, hp: Hyperparams,
                  batch_size: int, mesh=None, shuffle: str = "global",
                  placement=None) -> ModelState:
    """One generic epoch (``lightfm_tpu/train.py:258-320``): the shuffle,
    then one step per batch; with L2 on, the mid-epoch rescale guard after
    every step (``locked_regularize``, template:678-691) and a fold at the
    end (template:779-781, 910-912).  No host sync per step.

    Under a ``mesh`` each rank steps over its own columns of every batch
    with its columns of the draws; the step all-gathers its per-example
    quantities over the data axis and applies the full batch's update
    (``losses._apply_pointwise`` / ``_apply_pairwise``), so every replica
    takes the single-device step.  ``shuffle="local"`` takes each rank's
    keys from ``draws.perm`` viewed as ``[n_data, n_local]``.  ``placement``
    (a ``Placement`` of ``state`` on ``mesh``): the steps gather the table
    rows they read over the model axis and update the part of each table
    this rank holds; the folds are local."""
    from lightfm_tpu_torch.fast_warp import _unpack_batch5

    shuffled, cols = _epoch_batches(data, draws, batch_size, mesh, shuffle)
    step = LOSS_STEPS[hp.loss]
    lazy_reg = _lazy_reg(hp)
    for b in range(shuffled.shape[0]):
        batch = _unpack_batch5(shuffled[b])
        with observability.span("step"):
            state = step(state, batch, data.user_feats, data.item_feats, data.positives,
                         data.train_items, hp,
                         _step_draws(draws, b, batch, data.positives, hp, cols), mesh=mesh,
                         placement=placement)
            if lazy_reg:
                with observability.span("step.l2"):
                    state = maybe_fold_scales(state)
    if lazy_reg:
        with observability.span("epoch.l2_fold"):
            state = fold_scales(state)
    return state


def _no_op(hp: Hyperparams) -> bool:
    # Post-construction `model.max_sampled = 0`: the reference's sampling
    # loop never runs, so every WARP epoch is an exact no-op
    # (`tests/test_movielens.py:247-263`).
    return hp.max_sampled == 0 and hp.loss in ("warp", "warp-kos")


def _epoch(state, data, seed: int, hp, batch_size, fast, mesh=None, shuffle="global",
           placement=None):
    gen = torch.Generator(device=data.packed.device).manual_seed(int(seed))
    if not fast:
        draws = draw_generic_epoch(gen, data, hp, batch_size, mesh)
        return generic_epoch(state, data, draws, hp, batch_size, mesh, shuffle, placement)
    from lightfm_tpu_torch import fast_warp

    draws = fast_warp.draw_epoch(gen, data, hp, batch_size)
    return fast_warp.fast_epoch(state, data, draws, hp, batch_size, mesh=mesh)


def run_epochs(state: ModelState, data: TrainData, seeds, hp: Hyperparams,
               batch_size: int, fast=False, mesh=None, shuffle: str = "global",
               placement=None) -> ModelState:
    """One epoch per seed in ``seeds`` (uint32 values, one per epoch from
    the model's RandomState).  Returns a new state; the caller's tensors
    are left as they were (both paths update a copy in place).  Under a
    ``mesh`` every rank must pass the same seeds (``LightFM.fit`` takes
    rank 0's) and equal states, placed as ``placement`` (the generic path
    only: the fast path takes replicated tables)."""
    if _no_op(hp) or len(seeds) == 0:
        return state
    state = ModelState(*(x.clone() for x in state))
    for seed in seeds:
        state = _epoch(state, data, int(seed), hp, batch_size, fast, mesh, shuffle, placement)
    return state


def run_epoch(state: ModelState, data: TrainData, seed: int, hp: Hyperparams,
              batch_size: int, fast=False, mesh=None, shuffle: str = "global",
              placement=None) -> ModelState:
    """One epoch seeded by ``seed`` (the verbose per-epoch fit loop)."""
    return run_epochs(state, data, [seed], hp, batch_size, fast, mesh, shuffle, placement)
