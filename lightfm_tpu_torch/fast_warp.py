"""Fast training path (WARP, BPR and logistic): pool negatives + item-sorted
batches + sorted adagrad updates, with identity features or, for WARP and
BPR, narrow feature matrices (the hybrid path).

Counterpart of ``lightfm_tpu/fast_warp.py``, on one device or
data-parallel over a mesh of replicated tables (below).  As in the JAX
package (``lightfm_tpu/fast_warp.py:239-251``), :func:`fast_warp_eligible`
turns down every other table partition: a mesh fit with
``table_partition="rows"`` or ``"components"`` trains on the generic path
(:mod:`lightfm_tpu_torch.train`).  Per step:

- **Pool negatives** (WARP, BPR): one pool of ``P`` item ids and ``K``
  rotations; candidate k of example b is pool slot ``(b + shift_k) mod P``,
  so each example still scans K i.i.d. candidates in draw order
  (``_lightfm_fast.pyx.template:855-885``).  BPR draws its pool from the
  empirical item distribution (``train_items`` positions).
- **Item-sorted batches**: the epoch shuffle sorts each batch by positive
  item and emits the user-sorted ids plus the permutation ``sigma`` into
  them, so both table updates take sorted touches: the hand-written
  kernel K1 (:func:`lightfm_tpu_torch.ops.adagrad_update.sorted_adagrad_update`)
  on a CUDA device, its plain version on the CPU.
- **Pool-space negative updates**: violator gradients fold back to the
  ``[P, W]`` pool block, whose update is a P-row scatter.
- **Hybrid sides** (a :class:`PaddedRows` feature matrix of at most
  ``MAX_FAST_FEAT_NNZ`` padded entries per row): representations are
  weighted feature sums, and the feature table moves by the aggregated
  update -- per-entity gradient sums (kernel K3,
  :func:`lightfm_tpu_torch.ops.grad_sums.sorted_grad_sums`, for the sorted
  positives and users), a walk of the TRANSPOSED feature lists
  (:class:`TransposedFeats`) and a dense table move -- or, when no
  transposed structure is staged, by expanded per-(row, feature) scatters.

- **Data parallel** (``mesh``, identity features only): every rank
  shuffles the same epoch; each computes the forward pass and gradients of
  its contiguous ``B / n_data`` columns of the item-sorted batch, then the
  gradient streams are all-gathered over the data axis in rank order (so
  the gathered positives are the batch's sorted ids, as K1 needs) and the
  pool folds summed in rank order, and every rank applies the same
  full-batch update (``lightfm_tpu/fast_warp.py:780-786``).

Random draws are INPUTS: :func:`draw_epoch` draws an epoch's Feistel round
keys (or per-example sort keys), pool ids and shifts from a
``torch.Generator``; a test can derive the same draws from a ``jax.random``
key and run one epoch through both packages.

State updates happen IN PLACE: the step functions and :func:`fast_epoch`
update the four table/accumulator tensors of the state they are given and
return it.  ``train.run_epochs`` hands them a copy.

Numerics: ``fast_precision="highest"`` is IEEE fp32 with TF32 off;
``"default"`` rounds the operands of every contraction the JAX package runs
with ``precision=prec`` (candidate scores, the one-hot selection, the pool
fold, K1's and K3's sums, the transposed feature walk) to bf16, nearest
even, and sums in fp32.  A bf16 x bf16 product is exact in fp32, so the CPU
and the card agree.  The hybrid forward's feature sums have no precision
argument in the JAX package and stay IEEE fp32.  The scatters sum
duplicates in a fixed order (:func:`lightfm_tpu_torch.ops.updates.scatter_add`),
so two same-seed fits are bitwise equal.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import NamedTuple, Optional

import torch

from lightfm_tpu_torch import observability
from lightfm_tpu_torch.config import MAX_LOSS, Hyperparams
from lightfm_tpu_torch.losses import Batch
from lightfm_tpu_torch.ops.adagrad_update import sorted_adagrad_update
from lightfm_tpu_torch.ops.grad_sums import sorted_grad_sums
from lightfm_tpu_torch.ops.updates import scatter_add as _scatter_add
from lightfm_tpu_torch.ops.representation import (
    batch_representation,
    ieee_fp32,
    round_to_bf16,
    score_pairs,
    with_unit_bias,
)
from lightfm_tpu_torch.sparse import IdentityRows, PaddedRows, in_positives_slots
from lightfm_tpu_torch.state import ModelState, table_width

# Negative-pool size per step (at B <= POOL_SIZE the pool degenerates to
# per-example candidate sets).
POOL_SIZE = 16384

# Below this item-table footprint (rows * padded width) the generic path is
# the one that pays off; it also keeps small test datasets off this path.
MIN_TABLE_ELEMS = 1 << 19

# Hybrid (feature-matrix) fast path: PaddedRows up to this padded width are
# eligible for the pairwise pool path (the genre/tag case); wider or
# chunked feature rows belong on the generic path.
MAX_FAST_FEAT_NNZ = 16


def _feats_eligible(feats) -> bool:
    """Feature types the pairwise fast path handles natively."""
    if isinstance(feats, IdentityRows):
        return True
    return isinstance(feats, PaddedRows) and feats.max_nnz <= MAX_FAST_FEAT_NNZ

# The LIGHTFM_TPU_* env vars OVERRIDE the per-model fast-path knobs at fit
# time (process-wide A/B), with the JAX package's names and parsing.
_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off"}
_ENV_OVERRIDES = (
    # (env var, Hyperparams field, value aliases)
    ("LIGHTFM_TPU_FAST_WARP", "fast_path", {"1": "on", "0": "off"}),
    ("LIGHTFM_TPU_POOL_KERNELS", "pool_kernels", {"1": "kernels", "0": "einsum"}),
    ("LIGHTFM_TPU_FAST_WARP_USER_PALLAS", "user_pallas", None),  # bool
    ("LIGHTFM_TPU_FAST_WARP_PRECISION", "fast_precision", {}),
    ("LIGHTFM_TPU_FAST_SHUFFLE", "shuffle_mode", {}),
)

_U32 = 0xFFFFFFFF


def env_override_fields() -> dict:
    """Parse the set LIGHTFM_TPU_* env vars into a Hyperparams-field dict.

    Empty values mean UNSET.  Boolean fields accept 1/true/yes/on and
    0/false/no/off (anything else raises); enum fields pass unrecognised
    values through to Hyperparams' own validation.
    """
    updates = {}
    for env, field, aliases in _ENV_OVERRIDES:
        raw = os.environ.get(env)
        if raw is None or raw == "":
            continue
        if aliases is None:  # strict bool field
            low = raw.strip().lower()
            if low in _TRUTHY:
                updates[field] = True
            elif low in _FALSY:
                updates[field] = False
            else:
                raise ValueError(
                    f"{env}={raw!r}: expected one of {sorted(_TRUTHY | _FALSY)}"
                )
        else:
            updates[field] = aliases.get(raw, raw)
    return updates


def apply_env_overrides(hp: Hyperparams) -> Hyperparams:
    """Fold any set LIGHTFM_TPU_* env vars over the model's fast-path knobs
    (read at fit time; ``get_params`` keeps the constructor values)."""
    updates = env_override_fields()
    return dataclasses.replace(hp, **updates) if updates else hp


def _enabled(hp: Hyperparams, device: torch.device) -> bool:
    # "auto": CUDA devices only, where the JAX package checks for a TPU.
    if hp.fast_path == "off":
        return False
    if hp.fast_path == "on":
        return True
    return device.type == "cuda"


def _pool_mode(hp: Hyperparams) -> str:
    """Always the rolled-einsum formulation; ``pool_kernels="kernels"`` is
    a deprecated alias kept so old params and checkpoints load."""
    if hp.pool_kernels == "kernels":
        warnings.warn(
            "pool_kernels='kernels' was removed after losing the composed "
            "hardware A/B (doc/roadmap.md); running the einsum mode.",
            stacklevel=3,
        )
    return "einsum"


def fast_warp_eligible(hp: Hyperparams, data, mesh, shuffle: str, batch_size: int,
                       table_partition: str = "replicated", shard_examples: bool = False):
    """Static gate of the fast path (``lightfm_tpu/fast_warp.py:208-281``).

    Returns ``False`` or the pool mode ``"einsum"``.  WARP and BPR take
    feature matrices up to ``MAX_FAST_FEAT_NNZ`` padded entries per row;
    logistic takes identity features only.  With a ``mesh`` (a
    :class:`~lightfm_tpu_torch.parallel.Mesh`, else ``TypeError``) the path
    runs data-parallel, gated on the layouts that keep it exact: replicated
    tables, whole examples on every rank, the global shuffle, a batch that
    divides the data axis, for the pairwise losses a slice of whole pools,
    and identity features.
    """
    if mesh is not None:
        from lightfm_tpu_torch.parallel.mesh import check_mesh

        check_mesh(mesh)
    if not _enabled(hp, data.packed.device):
        return False
    if hp.loss not in ("warp", "bpr", "logistic") or hp.adadelta:
        return False
    if hp.loss == "bpr" and data.train_items is None:
        return False
    if hp.item_alpha != 0.0 or hp.user_alpha != 0.0:
        return False
    if shuffle != "global":
        return False
    if mesh is not None:
        if table_partition != "replicated" or shard_examples:
            return False
        n_data = mesh.shape["data"]
        if batch_size % n_data:
            return False
        # Pairwise losses: each rank's slice holds whole pool cycles, so an
        # example's slot (its position mod P) is the same in the slice.
        if hp.loss != "logistic" and (batch_size // n_data) % min(POOL_SIZE, batch_size):
            return False
    if hp.loss == "logistic" or mesh is not None:
        # Logistic's fast path is only the sorted update, over identity
        # touches; the data-parallel layout gathers identity touches only.
        if not isinstance(data.user_feats, IdentityRows):
            return False
        if not isinstance(data.item_feats, IdentityRows):
            return False
    elif not (_feats_eligible(data.user_feats) and _feats_eligible(data.item_feats)):
        return False
    if hp.loss != "logistic" and data.positives is None:
        return False
    # Pool-fold needs B to be a whole number of pools.
    if batch_size > POOL_SIZE and batch_size % POOL_SIZE != 0:
        return False
    # Item-table rows: the identity's row count, or the feature count of an
    # explicit feature matrix.
    if data.item_feats.n_cols * table_width(hp.no_components) < MIN_TABLE_ELEMS:
        return False
    return _pool_mode(hp)


# ---------------------------------------------------------------------------
# Epoch shuffle
# ---------------------------------------------------------------------------


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) and a constant
    ``c`` < 2^32, multiplied in 16-bit halves so no int64 product overflows
    (torch has no uint32 arithmetic)."""
    lo = x * (c & 0xFFFF)  # < 2^48
    hi = ((x * (c >> 16)) & 0xFFFF) << 16  # only its low 16 bits survive
    return (lo + hi) & _U32


def _hash_u32(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Keyed murmur3-style integer finalizer on u32 values held in int64."""
    x = _mul_u32(x ^ k, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul_u32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _feistel_batch_of(n: int, n_batches: int, round_keys: torch.Tensor) -> torch.Tensor:
    """Random balanced example -> batch assignment as a pointwise bijection
    (``lightfm_tpu/fast_warp.py:292-326``): four Feistel rounds on the
    mixed-radix grid ``(q, r) = (i // R, i % R)``, each round function
    reduced into its radix before the modular add, so every batch gets
    exactly ``n / n_batches`` members.  ``round_keys``: 4 u32 values."""
    R = n_batches
    Q = n // n_batches
    ks = round_keys.to(torch.int64)
    i = torch.arange(n, dtype=torch.int64, device=round_keys.device)
    q, r = i // R, i % R
    q = (q + _hash_u32(r, ks[0]) % Q) % Q
    r = (r + _hash_u32(q, ks[1]) % R) % R
    q = (q + _hash_u32(r, ks[2]) % Q) % Q
    r = (r + _hash_u32(q, ks[3]) % R) % R
    return r.to(torch.int32)


def _stable_order(major: torch.Tensor, minor: torch.Tensor) -> torch.Tensor:
    """Stable sort order by the pair (major, minor) of non-negative int32
    values, as one int64 key."""
    key = (major.to(torch.int64) << 32) | minor.to(torch.int64)
    return torch.sort(key, stable=True).indices


@observability.spanned("epoch.shuffle")
def shuffle_item_sorted(packed: torch.Tensor, perm: torch.Tensor, n_batches: int,
                        batch_size: int, mode: str = "feistel"):
    """Per-epoch shuffle emitting item-sorted batches + user-sort metadata
    (``lightfm_tpu/fast_warp.py:334-406``, bitwise given the same draws).

    ``mode="feistel"``: ``perm`` holds the 4 round keys of
    :func:`_feistel_batch_of`, and one stable sort by (batch, item) orders
    each batch.  ``mode="sort"``: ``perm`` holds one u32 key per example; a
    stable sort by it is a uniform permutation, cut into batches by
    position, then each batch is sorted by item.  Finally a stable sort by
    (batch, user) gives each batch's user-sorted ids and the permutation
    ``sigma`` from user-sorted slots into item-sorted ones.

    Returns ``(shuffled int32 [n_batches, 5, B], suid int32 [n_batches, B],
    sigma int32 [n_batches, B])``; rows of ``shuffled``: user, item, value
    bits, weight bits, valid.
    """
    n = packed.shape[1]
    dev = packed.device
    batch_of = torch.arange(n, dtype=torch.int64, device=dev) // batch_size
    if mode == "sort":
        cols = packed[:5, torch.sort(perm.to(torch.int64), stable=True).indices]
        cols = cols[:, _stable_order(batch_of, cols[1])]
    else:
        assign = _feistel_batch_of(n, n_batches, perm)
        cols = packed[:5, _stable_order(assign, packed[1])]
    user_s = cols[0]
    shuffled = cols.reshape(5, n_batches, batch_size).transpose(0, 1).contiguous()

    pos_in_batch = (torch.arange(n, dtype=torch.int64, device=dev) % batch_size).to(torch.int32)
    order = _stable_order(batch_of, user_s)
    suid = user_s[order].reshape(n_batches, batch_size)
    sigma = pos_in_batch[order].reshape(n_batches, batch_size)
    return shuffled, suid, sigma


def _unpack_batch5(packed: torch.Tensor) -> Batch:
    """[5, B] int32 packed rows -> Batch (float rows bit-cast back)."""
    return Batch(
        user_ids=packed[0],
        item_ids=packed[1],
        y=packed[2].view(torch.float32),
        weight=packed[3].view(torch.float32),
        valid=packed[4] > 0,
    )


# ---------------------------------------------------------------------------
# Random draws
# ---------------------------------------------------------------------------


class EpochDraws(NamedTuple):
    """One epoch's random draws (int64 tensors of u32 / index values).

    ``perm``: [4] Feistel round keys, or [n_pad] per-example sort keys
    (``shuffle_mode="sort"``).  ``pool``: [n_batches, P] pool item ids
    (WARP) or positions into ``train_items`` (BPR).  ``shifts``:
    [n_batches, K] pool rotations, K = ``max_sampled`` (WARP) or
    ``bpr_tries`` (BPR).  Logistic draws no pool: both are None.
    """

    perm: torch.Tensor
    pool: Optional[torch.Tensor]
    shifts: Optional[torch.Tensor]


@observability.spanned("epoch.draws")
def draw_epoch(gen: torch.Generator, data, hp: Hyperparams, batch_size: int) -> EpochDraws:
    """Draw one epoch's :class:`EpochDraws` from ``gen`` on its device."""
    dev = gen.device
    n_pad = data.packed.shape[1]
    n_batches = n_pad // batch_size
    n_perm = n_pad if hp.shuffle_mode == "sort" else 4
    perm = torch.randint(0, 1 << 32, (n_perm,), generator=gen, device=dev, dtype=torch.int64)
    if hp.loss == "logistic":
        return EpochDraws(perm, None, None)
    P = min(POOL_SIZE, batch_size)
    if hp.loss == "bpr":
        high, K = data.train_items.shape[0], hp.bpr_tries
    else:
        high, K = data.item_feats.n_rows, hp.max_sampled
    pool = torch.randint(0, high, (n_batches, P), generator=gen, device=dev)
    shifts = torch.randint(0, P, (n_batches, K), generator=gen, device=dev)
    return EpochDraws(perm, pool, shifts)


# ---------------------------------------------------------------------------
# Contractions and updates
# ---------------------------------------------------------------------------


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """fp32 einsum with TF32 off; at ``"default"`` both operands are first
    rounded to bf16 (the product of two bf16 values is exact in fp32)."""
    if precision == "default":
        a, b = round_to_bf16(a), round_to_bf16(b)
    with ieee_fp32(a):
        return torch.einsum(eq, a, b)


def _roll_index(shifts: torch.Tensor, P: int) -> torch.Tensor:
    """[K, P] gather index of K rotations: ``jnp.roll(x, -shift_k)[s] ==
    x[(s + shift_k) % P]``."""
    s = torch.arange(P, dtype=torch.int64, device=shifts.device)
    return (s[None, :] + shifts.to(torch.int64)[:, None]) % P


def _roll_ids(pool_ids: torch.Tensor, shifts: torch.Tensor, K: int) -> torch.Tensor:
    """K rotated views of the pool's ids ([K, P])."""
    return pool_ids[_roll_index(shifts[:K], pool_ids.shape[0])]


def _rolled_reps(pool_reps: torch.Tensor, shifts: torch.Tensor, K: int) -> torch.Tensor:
    """K rotated copies of the pool's reps ([K, P, W])."""
    return pool_reps[_roll_index(shifts[:K], pool_reps.shape[0])]


def _nrep_einsum(onehot, rp, Q: int, P: int, precision: str) -> torch.Tensor:
    """Selected-candidate reps via a one-hot contraction over rolled copies."""
    K, _, W = rp.shape
    return _einsum("kqs,ksd->qsd", onehot.reshape(K, Q, P), rp, precision).reshape(Q * P, W)


def _fold_gp_einsum(sel, u1q, shifts, precision: str):
    """Pool-space gradient fold: (gp, gp2) [P, W], the sel-weighted u1 (and
    sel^2-weighted u1^2) summed at each candidate's pool slot.  Rotations
    fold back in k order, as the JAX package adds them."""
    K = sel.shape[0]
    Q, P, W = u1q.shape
    selq = sel.reshape(K, Q, P)
    g_roll = _einsum("kqs,qsd->ksd", selq, u1q, precision)  # [K, P, W] rolled space
    g2_roll = _einsum("kqs,qsd->ksd", (sel * sel).reshape(K, Q, P), u1q * u1q, precision)
    # jnp.roll(x, +shift)[s] == x[(s - shift) % P]
    back = _roll_index(-shifts[:K].to(torch.int64), P)
    gp = torch.zeros((P, W), dtype=torch.float32, device=u1q.device)
    gp2 = torch.zeros_like(gp)
    for k in range(K):
        gp = gp + g_roll[k][back[k]]
        gp2 = gp2 + g2_roll[k][back[k]]
    return gp, gp2


def _sorted_update(table, acc, sidx, wg, lr: float, precision: str):
    """Adagrad update over SORTED touches through K1 (in place)."""
    return sorted_adagrad_update(table, acc, sidx, wg.contiguous(), lr, precision)


def _scatter_update(table, acc, rows, g, g2, lr: float):
    """In-place adagrad scatter with the pre-call accumulator:
    ``table[rows] -= lr * rsqrt(acc[rows]) * g``, ``acc[rows] += g2``,
    duplicates summed, deterministically."""
    rows = rows.long()
    lrl = lr * torch.rsqrt(acc[rows])
    _scatter_add(table, rows, -(lrl * g))
    _scatter_add(acc, rows, g2)


def _feature_update(table, acc, feats: PaddedRows, rows, g, lr: float, g2=None):
    """In-place adagrad update through an explicit feature matrix
    (``lightfm_tpu/fast_warp.py:437-461``): per-row gradients ``g`` expand
    to per-(row, feature) touches ``w_f * g`` and scatter-add
    (``update_features``, template:392-451, batched), each touch reading the
    PRE-call accumulator; zero-weight padding slots are exact no-ops.
    ``g2`` overrides the squared-gradient stream for callers whose ``g`` is
    already a fold of per-example terms (the pool negatives)."""
    rows = rows.long()
    idx = feats.idx[rows]  # [B, P]
    w = feats.wts[rows]
    W = g.shape[-1]
    fidx = idx.reshape(-1).long()
    fwg = (w[..., None] * g[:, None, :]).reshape(-1, W)
    if g2 is None:
        fwg2 = fwg * fwg
    else:
        fwg2 = ((w * w)[..., None] * g2[:, None, :]).reshape(-1, W)
    lrl = lr * torch.rsqrt(acc[fidx])
    _scatter_add(table, fidx, -(lrl * fwg))
    _scatter_add(acc, fidx, fwg2)


class TransposedFeats(NamedTuple):
    """Transposed feature lists split by row width, for the aggregated
    hybrid update (``LightFM._transposed_features`` builds it at staging).

    ``thin``: :class:`PaddedRows` over the narrow rows (identity columns
    transpose to width-1 rows), walked with small gathers.
    ``fat_rows``/``fat_w``/``fat_w2``: the wide rows (tag/genre columns
    list hundreds of entities) as DENSE ``[M, n_entities]`` weight
    matrices, walked by one matrix product against ``G``.  ``fat_w2`` holds
    the squared weights; when they equal the weights (binary weights) it is
    the SAME tensor as ``fat_w``.  Stored bf16 under
    ``fast_precision="default"`` when the data round-trips exactly.
    """

    thin: object  # PaddedRows (or ChunkedRows)
    fat_rows: Optional[torch.Tensor]  # int32 [M] feature ids of the fat rows
    fat_w: Optional[torch.Tensor]  # [M, n_entities] weights (f32 or bf16)
    fat_w2: Optional[torch.Tensor]  # [M, n_entities] squared weights


def _fat_product(w: torch.Tensor, g: torch.Tensor, precision: str) -> torch.Tensor:
    """f32 ``w @ g`` of the fat tier.  bf16-stored ``w`` is upcast (exact)
    so the product accumulates and returns f32 as the JAX package's
    ``preferred_element_type=f32`` dot does; at ``"default"`` both operands
    are bf16-rounded first, so the f32 product with TF32 off is exact per
    term."""
    if precision == "default":
        g = round_to_bf16(g)
        if w.dtype != torch.bfloat16:
            w = round_to_bf16(w)
    w = w.float()
    with ieee_fp32(g):
        return w @ g


def _transposed_feature_sums(feats_T, G: torch.Tensor, block: int = 8192,
                             precision: str = "highest") -> torch.Tensor:
    """Per-feature weighted sums of per-entity gradient rows
    (``lightfm_tpu/fast_warp.py:487-581``).

    ``G`` is the ``[n_entities, 2W]`` stacked ``[G1 | G2]`` block of
    per-entity gradient sums; ``feats_T`` is the TRANSPOSED feature
    structure (row f lists the entities carrying feature f with weights
    ``w``).  Returns ``[n_features, 2W]`` with ``S1[f] = sum_e w * G1[e]``
    and ``S2[f] = sum_e w^2 * G2[e]``: the per-feature sums of the expanded
    touch set of :func:`_feature_update`, with no scatter but the fat
    tier's add at its (unique) rows.  The thin walk runs in row blocks so
    each ``[block, width, 2W]`` gather stays inside 2^25 elements.
    """
    W2 = G.shape[1]
    W = W2 // 2

    def fold(idx, w):
        emb = G[idx.long()]  # [..., P, 2W]
        s1 = _einsum("...p,...pd->...d", w, emb[..., :W], precision)
        s2 = _einsum("...p,...pd->...d", w * w, emb[..., W:], precision)
        return torch.cat([s1, s2], dim=-1)

    fat = None
    if isinstance(feats_T, TransposedFeats):
        fat = feats_T
        feats_T = feats_T.thin
    if isinstance(feats_T, PaddedRows):
        base_idx, base_wts = feats_T.idx, feats_T.wts
        over = None
    else:  # ChunkedRows
        base_idx, base_wts = feats_T.base.idx, feats_T.base.wts
        over = feats_T

    budget_elems = 1 << 25
    F = base_idx.shape[0]
    per_row = max(1, base_idx.shape[1] * W2)
    block = max(8, min(block, budget_elems // per_row))
    S = torch.cat(
        [fold(base_idx[r0:r0 + block], base_wts[r0:r0 + block]) for r0 in range(0, F, block)]
        or [G.new_zeros((0, W2))]
    )

    if over is not None:
        # Overflow tier: fold each chunk over its M+1 overflow records
        # (record M is all-zero padding) and route back per feature through
        # over_slot.  Wide chunks are split column-wise so each fold's
        # gather stays inside the budget (the splits only add summands).
        oi, ow = over.over_idx, over.over_wts
        n_ch, M1, C = oi.shape
        sub = C
        while sub > 8 and M1 * sub * W2 > budget_elems:
            sub //= 2
        if sub < C:
            k = C // sub
            oi = oi.reshape(n_ch, M1, k, sub).transpose(1, 2).reshape(n_ch * k, M1, sub)
            ow = ow.reshape(n_ch, M1, k, sub).transpose(1, 2).reshape(n_ch * k, M1, sub)
        slot = over.over_slot.long()
        for idx_c, wts_c in zip(oi, ow):
            S = S + fold(idx_c, wts_c)[slot]

    if fat is not None and fat.fat_rows is not None:
        # Fat tier: S1 += W @ G1, S2 += W^2 @ G2 as two f32 matrix products
        # (the JAX package leaves these to XLA's dot; a library matmul here).
        s1 = _fat_product(fat.fat_w, G[:, :W], precision)
        s2 = _fat_product(fat.fat_w2, G[:, W:], precision)
        S.index_add_(0, fat.fat_rows.long(), torch.cat([s1, s2], dim=1))  # rows are unique
    return S


def _aggregated_feature_update(table, acc, feats_T, G, lr: float, precision: str = "highest"):
    """Scatter-free in-place adagrad update through an explicit feature
    matrix (``lightfm_tpu/fast_warp.py:584-603``): the exact reformulation of
    one expanded-touch :func:`_feature_update` call.  Per-feature sums come
    from the transposed walk, then the table and accumulator move densely;
    untouched features have zero sums (exact no-ops), and every feature
    reads this call's pre-call accumulator."""
    W = table.shape[1]
    S = _transposed_feature_sums(feats_T, G, precision=precision)
    lrl = lr * torch.rsqrt(acc)
    table.sub_(lrl * S[:, :W])
    acc.add_(S[:, W:])


@observability.spanned("step.update")
def _apply_pool_updates(state: ModelState, uid, pos_ids, gi, gu, suid, sigma,
                        pool_ids, gp, gp2, lr: float, user_pallas: bool,
                        precision: str, user_feats=None, item_feats=None,
                        user_feats_T=None, item_feats_T=None) -> ModelState:
    """``lightfm_tpu/fast_warp.py:651-777`` (in place).

    Order within the step: positive items (pre-step accumulator), pool
    negatives (post-positive accumulator), users (pre-step accumulator).
    Identity sides take K1 over the sorted ids (or, for users with
    ``user_pallas=False``, a B-row scatter) and a P-row pool scatter.  A
    feature-matrix side with a staged transposed structure takes the
    aggregated update -- per-entity sums by K3 over the sorted positives
    (items) or the user-sorted ids (users), the pool's by a scatter into
    zeros -- and otherwise the expanded-touch scatter.  Positives and pool
    stay two phases, so the pool reads the accumulator as the positives
    left it.
    """
    item_identity = item_feats is None or isinstance(item_feats, IdentityRows)
    user_identity = user_feats is None or isinstance(user_feats, IdentityRows)
    W = gi.shape[1]

    if item_identity:
        _sorted_update(state.item_table, state.item_acc, pos_ids, -gi, lr, precision)
        _scatter_update(state.item_table, state.item_acc, pool_ids, gp, gp2, lr)
    elif item_feats_T is not None:
        n_i = item_feats.n_rows
        Gp = sorted_grad_sums(pos_ids, (-gi).contiguous(), n_i, precision)
        _aggregated_feature_update(state.item_table, state.item_acc, item_feats_T, Gp, lr,
                                   precision)
        Gn = torch.zeros((n_i, 2 * W), dtype=torch.float32, device=gi.device)
        _scatter_add(Gn, pool_ids.long(), torch.cat([gp, gp2], dim=1))
        _aggregated_feature_update(state.item_table, state.item_acc, item_feats_T, Gn, lr,
                                   precision)
    else:
        _feature_update(state.item_table, state.item_acc, item_feats, pos_ids, -gi, lr)
        _feature_update(state.item_table, state.item_acc, item_feats, pool_ids, gp, lr, g2=gp2)

    if not user_identity:
        if user_feats_T is not None:
            Gu = sorted_grad_sums(suid, gu[sigma.long()].contiguous(), user_feats.n_rows,
                                  precision)
            _aggregated_feature_update(state.user_table, state.user_acc, user_feats_T, Gu, lr,
                                       precision)
        else:
            _feature_update(state.user_table, state.user_acc, user_feats, uid, gu, lr)
    elif user_pallas:
        _sorted_update(state.user_table, state.user_acc, suid, gu[sigma.long()], lr, precision)
    else:
        _scatter_update(state.user_table, state.user_acc, uid, gu, gu * gu, lr)
    return state


def _gather_streams(mesh, uid, pos_ids, gi, gu, gp, gp2):
    """Under a mesh: the per-example streams all-gathered over the data axis
    (rank order restores the sorted batch) and the pool folds summed in
    rank order (``lightfm_tpu/fast_warp.py:880-885``); else as they are."""
    if mesh is None:
        return uid, pos_ids, gi, gu, gp, gp2
    from lightfm_tpu_torch.parallel.mesh import all_gather_rows, sum_over_data

    with observability.span("step.gather"):
        uid, pos_ids, gi, gu = all_gather_rows(mesh, uid, pos_ids, gi, gu)
        gp, gp2 = sum_over_data(mesh, gp, gp2)
    return uid, pos_ids, gi, gu, gp, gp2


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


@observability.spanned("step")
def warp_pool_step(state: ModelState, batch: Batch, positives, suid, sigma,
                   hp: Hyperparams, pool_ids, shifts, *, n_items: int,
                   user_pallas: bool, user_feats=None, item_feats=None,
                   user_feats_T=None, item_feats_T=None, mesh=None) -> ModelState:
    """One WARP step over an ITEM-SORTED batch (in place).

    Per example: the first margin violator that is not a positive among K
    pool candidates, rank weight ``log(floor((n_items-1)/draws))``, loss
    clipped at MAX_LOSS (``_lightfm_fast.pyx.template:784-912``).
    ``pool_ids`` [P] and ``shifts`` [K] are this step's draws.  With a
    feature matrix on a side, its representations are the weighted feature
    sums (``compute_representation``, template:287-317).

    Under a ``mesh`` the batch is this rank's contiguous slice of the
    item-sorted batch (whole pools of ``P = len(pool_ids)``); ``suid`` and
    ``sigma`` stay the full batch's.  The gradient streams are gathered and
    the pool folds summed over the data axis before the update.
    """
    uid, pos_ids = batch.user_ids, batch.item_ids
    B = uid.shape[0]
    K = hp.max_sampled
    P = pool_ids.shape[0]
    Q = B // P
    W = state.item_table.shape[1]
    prec = hp.fast_precision

    with observability.span("step.score"):
        u = batch_representation(state.user_table, user_feats, uid)  # [B, W]
        prep = batch_representation(state.item_table, item_feats, pos_ids)
        pool_ids = pool_ids.to(torch.int32)
        pool_reps = batch_representation(state.item_table, item_feats, pool_ids)
        rids = _roll_ids(pool_ids, shifts, K)

        u1 = with_unit_bias(u)
        pos_pred = score_pairs(u, prep)  # [B]
        rp = _rolled_reps(pool_reps, shifts, K)
        u1q = u1.reshape(Q, P, W)
        preds = (
            _einsum("qsd,ksd->kqs", u1q, rp, prec) + u[:, -1].reshape(1, Q, P)
        ).reshape(K, B)
        cand_ids = rids[:, None, :].expand(K, Q, P).reshape(K, B)

        violates = preds > pos_pred[None, :] - 1.0  # template:875
        is_pos = in_positives_slots(positives, uid, cand_ids)  # template:878
        cand = violates & ~is_pos
        found = cand.any(0)
        j = torch.argmax(cand.to(torch.uint8), 0)  # first maximum, as jnp.argmax
        sampled = (j + 1).to(torch.float32)
        rank_weight = torch.log(torch.clamp(torch.floor((n_items - 1) / sampled), min=1.0))
        loss = torch.clamp(batch.weight * rank_weight, max=MAX_LOSS)  # template:881-885
        upd = batch.valid & (batch.y > 0) & found  # template:831
        lossm = torch.where(upd, loss, torch.zeros_like(loss))  # masked: exact no-ops

    with observability.span("step.grads"):
        onehot = (j[None, :] == torch.arange(K, device=j.device)[:, None]).to(torch.float32)
        nrep = _nrep_einsum(onehot, rp, Q, P, prec)
        sel = onehot * lossm[None, :]
        gp, gp2 = _fold_gp_einsum(sel, u1q, shifts, prec)

        # Gradients (warp_update, template:537-649), fused [emb | bias] layout.
        gi = lossm[:, None] * u1
        gu = lossm[:, None] * with_unit_bias(nrep - prep)
    uid, pos_ids, gi, gu, gp, gp2 = _gather_streams(mesh, uid, pos_ids, gi, gu, gp, gp2)
    return _apply_pool_updates(
        state, uid, pos_ids, gi, gu, suid, sigma, pool_ids, gp, gp2,
        hp.learning_rate, user_pallas, prec, user_feats=user_feats,
        item_feats=item_feats, user_feats_T=user_feats_T, item_feats_T=item_feats_T,
    )


@observability.spanned("step")
def bpr_pool_step(state: ModelState, batch: Batch, positives, train_items,
                  suid, sigma, hp: Hyperparams, pool_pos, shifts, *,
                  user_pallas: bool, user_feats=None, item_feats=None,
                  user_feats_T=None, item_feats_T=None, mesh=None) -> ModelState:
    """One BPR step over an ITEM-SORTED batch (in place).

    The negative is the first of ``bpr_tries`` pool candidates that is not
    a positive, else the last (``fit_bpr``, template:1074-1182); the pool is
    ``train_items[pool_pos]``, the empirical item distribution.  Under a
    ``mesh`` as :func:`warp_pool_step`.
    """
    uid, pos_ids = batch.user_ids, batch.item_ids
    B = uid.shape[0]
    T = hp.bpr_tries
    P = pool_pos.shape[0]
    Q = B // P
    W = state.item_table.shape[1]
    prec = hp.fast_precision

    with observability.span("step.score"):
        u = batch_representation(state.user_table, user_feats, uid)
        prep = batch_representation(state.item_table, item_feats, pos_ids)
        pool_ids = train_items[pool_pos.long()]
        pool_reps = batch_representation(state.item_table, item_feats, pool_ids)
        rids = _roll_ids(pool_ids, shifts, T)
        cand_ids = rids[:, None, :].expand(T, Q, P).reshape(T, B)

        ok = ~in_positives_slots(positives, uid, cand_ids)  # [T, B]
        j = torch.where(
            ok.any(0), torch.argmax(ok.to(torch.uint8), 0),
            torch.full_like(uid, T - 1, dtype=torch.int64),
        )
        u1 = with_unit_bias(u)
        rp = _rolled_reps(pool_reps, shifts, T)
        u1q = u1.reshape(Q, P, W)
        onehot = (j[None, :] == torch.arange(T, device=j.device)[:, None]).to(torch.float32)
        nrep = _nrep_einsum(onehot, rp, Q, P, prec)

        pos_pred = score_pairs(u, prep)
        neg_pred = score_pairs(u, nrep)
        loss = batch.weight * (1.0 - torch.sigmoid(pos_pred - neg_pred))  # template:1158
        upd = batch.valid & (batch.y > 0)  # template:1116
        lossm = torch.where(upd, loss, torch.zeros_like(loss))

    with observability.span("step.grads"):
        sel = onehot * lossm[None, :]
        gp, gp2 = _fold_gp_einsum(sel, u1q, shifts, prec)
        gi = lossm[:, None] * u1
        gu = lossm[:, None] * with_unit_bias(nrep - prep)
    uid, pos_ids, gi, gu, gp, gp2 = _gather_streams(mesh, uid, pos_ids, gi, gu, gp, gp2)
    return _apply_pool_updates(
        state, uid, pos_ids, gi, gu, suid, sigma, pool_ids, gp, gp2,
        hp.learning_rate, user_pallas, prec, user_feats=user_feats,
        item_feats=item_feats, user_feats_T=user_feats_T, item_feats_T=item_feats_T,
    )


@observability.spanned("step")
def logistic_sorted_step(state: ModelState, batch: Batch, suid, sigma,
                         hp: Hyperparams, *, user_pallas: bool, mesh=None) -> ModelState:
    """One logistic step over an ITEM-SORTED batch (in place): sigmoid
    prediction, y = 1 iff value > 0, gradient ``weight * (pred - y)``
    (``fit_logistic``, template:694-781); no sampling.  Under a ``mesh`` as
    :func:`warp_pool_step`, with no pool."""
    uid, iid = batch.user_ids, batch.item_ids
    with observability.span("step.score"):
        u = state.user_table[uid.long()]
        irep = state.item_table[iid.long()]
        pred = torch.sigmoid(score_pairs(u, irep))
        y01 = (batch.y > 0).to(torch.float32)  # template:751-758
        loss = torch.where(batch.valid, batch.weight * (pred - y01), torch.zeros_like(pred))

    with observability.span("step.grads"):
        gi = loss[:, None] * with_unit_bias(u)
        gu = loss[:, None] * with_unit_bias(irep)
    if mesh is not None:
        from lightfm_tpu_torch.parallel.mesh import all_gather_rows

        with observability.span("step.gather"):
            uid, iid, gi, gu = all_gather_rows(mesh, uid, iid, gi, gu)
    prec = hp.fast_precision
    lr = hp.learning_rate
    with observability.span("step.update"):
        _sorted_update(state.item_table, state.item_acc, iid, gi, lr, prec)
        if user_pallas:
            _sorted_update(state.user_table, state.user_acc, suid, gu[sigma.long()], lr, prec)
        else:
            _scatter_update(state.user_table, state.user_acc, uid, gu, gu * gu, lr)
    return state


def fast_epoch(state: ModelState, data, draws: EpochDraws, hp: Hyperparams,
               batch_size: int, mesh=None) -> ModelState:
    """One fast-path epoch (in place): item-sorted shuffle, then one step
    per batch with that batch's draws and the staged feature structures.
    Under a ``mesh`` every rank shuffles the whole epoch and steps over its
    data coordinate's contiguous columns of each sorted batch."""
    n_pad = data.packed.shape[1]
    n_batches = n_pad // batch_size
    n_items = data.item_feats.n_rows
    shuffled, suid, sigma = shuffle_item_sorted(
        data.packed, draws.perm, n_batches, batch_size, hp.shuffle_mode
    )
    feats = dict(user_feats=data.user_feats, item_feats=data.item_feats,
                 user_feats_T=data.user_feats_T, item_feats_T=data.item_feats_T, mesh=mesh)
    cols = slice(None)
    if mesh is not None:
        b_local = batch_size // mesh.shape["data"]
        d = mesh.coords["data"]
        cols = slice(d * b_local, (d + 1) * b_local)
    for b in range(n_batches):
        batch = _unpack_batch5(shuffled[b][:, cols])
        if hp.loss == "logistic":
            logistic_sorted_step(state, batch, suid[b], sigma[b], hp, user_pallas=hp.user_pallas,
                                 mesh=mesh)
        elif hp.loss == "bpr":
            bpr_pool_step(
                state, batch, data.positives, data.train_items, suid[b], sigma[b],
                hp, draws.pool[b], draws.shifts[b], user_pallas=hp.user_pallas, **feats,
            )
        else:
            warp_pool_step(
                state, batch, data.positives, suid[b], sigma[b], hp,
                draws.pool[b], draws.shifts[b], n_items=n_items,
                user_pallas=hp.user_pallas, **feats,
            )
    return state
