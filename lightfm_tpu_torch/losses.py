"""Batched training steps of the generic path: logistic, BPR, WARP, WARP-kOS.

Counterpart of ``lightfm_tpu/losses.py``.  Each step processes a whole
minibatch at once (the reference's per-sample loops are ``fit_logistic``
template:694-781, ``fit_warp`` :784-912, ``fit_warp_kos`` :915-1071 and
``fit_bpr`` :1074-1182):

- WARP draws ``max_sampled`` negatives a row at once (slot-major
  ``[K, B]``), takes the first margin violator that is not a positive, and
  weights the loss by ``log(floor((n_items-1)/draws used))``;
- BPR draws ``bpr_tries`` training interactions a row and takes the first
  whose item is not a positive of the user (the last draw if none is);
- k-OS samples ``n`` of the user's positives with replacement, takes the
  ``min(k, #sampled)``-th best as the positive, then searches as WARP.

Gradients follow ``update`` (template:454-534) and ``warp_update``
(template:537-649): one fused ``[B, W]`` gradient per table, bias in the
last column, applied by :func:`lightfm_tpu_torch.ops.updates.sparse_update`
in place on the state's tensors.

The port cannot reproduce ``jax.random``, so every step takes its random
draws as integer tensors (``draws``) instead of a key:

==========  ===========================================================
WARP        negative item ids ``[K, B]``
BPR         positions into ``train_items`` ``[B, T]``
k-OS        ``(positive slots [n, B], negative item ids [K, B])``
logistic    None
==========  ===========================================================

Under a device mesh (``mesh``) a step gets this rank's columns of the
batch and of the draws; it computes their representations and losses,
all-gathers them over the data axis and applies the whole batch's update
on every rank, the single-device update (``lightfm_tpu/train.py:276-283``,
where GSPMD does the same).  Under a row or component partition
(``placement``, a :class:`~lightfm_tpu_torch.parallel.mesh.Placement`)
every table read gathers the whole rows over the model axis, and each rank
applies the touches of the rows or columns it holds; the lazy-L2
statistics of those touches are summed over the model axis in rank order.

Each step marks its parts with the fast path's span names: ``step.score``
(representations, scores, the sampling decisions and the loss),
``step.grads`` (gradients and their per-feature touches), ``step.update``
(the sparse optimizer pass of both tables) and, with L2 on, ``step.l2``
(the scale bump; the generic epoch marks the rescale guard that follows
it with a second ``step.l2``).  The k-OS step marks its pick inside
``step.score`` as ``step.kos`` (the sampled positives' slots, their
scores, their order and the k-th, before the negative search), and the
BPR step its negative's pick as ``step.bpr`` (the tries' items, the test
against the user's positives and the first accepted try, before the
scoring).  Counters, from shapes alone: ``update_touches.item`` and
``update_touches.user`` (touch slots a step hands the optimizer, padding
and examples that do not update included); ``kos_draws`` (the k-OS
step's sampled positive slots, ``n * B`` a step); ``bpr_draws`` (the BPR
step's tries, ``B * T`` a step).

The fast path's steps live in :mod:`lightfm_tpu_torch.fast_warp`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lightfm_tpu_torch import observability
from lightfm_tpu_torch.config import MAX_LOSS, Hyperparams
from lightfm_tpu_torch.ops.representation import (
    batch_representation,
    candidate_scores,
    score_pairs,
    with_unit_bias,
)
from lightfm_tpu_torch.ops.updates import sparse_update
from lightfm_tpu_torch.sparse import ChunkedRows, IdentityRows, in_positives, in_positives_slots
from lightfm_tpu_torch.state import ModelState


class Batch(NamedTuple):
    user_ids: torch.Tensor  # int32 [B]
    item_ids: torch.Tensor  # int32 [B]
    y: torch.Tensor  # f32 [B]
    weight: torch.Tensor  # f32 [B]
    valid: torch.Tensor  # bool [B]


def _side(placement, side: str):
    """One side's ``TablePlacement`` of a ``Placement`` (None: whole tables)."""
    return None if placement is None else getattr(placement, side)


def _own(placement, idx, mask, g):
    """The touches of the part of a table this rank holds:
    ``placement.own``, or all of them without a placement."""
    return (idx, mask, g, {}) if placement is None else placement.own(idx, mask, g)


def _lazy_reg(hp: Hyperparams) -> bool:
    return hp.item_alpha != 0.0 or hp.user_alpha != 0.0


def _scales(state: ModelState, hp: Hyperparams):
    """Lazy-reg scale accumulators, or (None, None) when alpha == 0 (the
    scales are then exactly 1 forever and the multiply is skipped).  Reads
    come before the step's bump and ``maybe_fold_scales`` runs every step,
    so the log scales stay <= LOG_MAX_REG_SCALE and exp is finite."""
    if not _lazy_reg(hp):
        return None, None
    return torch.exp(state.user_log_scale), torch.exp(state.item_log_scale)


def _flatten_touches(features, rows: torch.Tensor, g: torch.Tensor, mask: torch.Tensor):
    """Expand per-row ``[B, W]`` gradients to per-(row, feature) touches.

    Identity features touch their own row.  Padded features expand to
    ``[B*P]`` touches with the RAW feature weights (the reference scales
    only the read path, template:311 vs :366).  Returns ``(touches,
    overflow)``: the flat ``(idx, w, g, mask)`` of the dense tier, and for
    :class:`ChunkedRows` the ``(slots, g, mask, first feature)`` of the
    over-width tail (applied chunk by chunk in :func:`_overflow_chunks`),
    else None.
    """
    if isinstance(features, IdentityRows):
        return (rows, torch.ones(rows.shape, dtype=g.dtype, device=g.device), g, mask), None
    if isinstance(features, ChunkedRows):
        base, _ = _flatten_touches(features.base, rows, g, mask)
        rows = rows.long()
        return base, (features.over_slot[rows], g, mask, features.base.idx[rows, 0])
    rows = rows.long()
    idx = features.idx[rows]  # [B, P]
    w = features.wts[rows]
    B, P = idx.shape
    tmask = mask[:, None] & (w != 0)
    idx = _off_row_zero(idx, tmask, idx[:, :1])
    g_flat = g[:, None, :].expand(B, P, g.shape[1]).reshape(B * P, -1)
    return (idx.reshape(-1), w.reshape(-1), g_flat, tmask.reshape(-1)), None


def _off_row_zero(idx: torch.Tensor, tmask: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Point every masked touch at its entity's first feature.

    A masked touch adds a signed zero and multiplies by exactly 1.0, which
    leaves every value of any row as it is (at most a -0.0 turns +0.0, as
    on row 0 in the JAX package), so where it points does not change the
    result.  Padding slots hold feature 0, though, and an ordered
    scatter-add that sums a row's duplicates one after another (PyTorch's
    CUDA ``index_put_(accumulate=True)``, which the card's adadelta branch
    used before its kernel) made one serial sum of a million terms of a
    chunked step with every padding slot on row 0.  The entity's first
    feature is a row its own touches reach anyway.  (The card's kernels
    skip masked touches wherever they point.)
    """
    return torch.where(tmask, idx, first)


def _update_scales(state: ModelState, hp: Hyperparams, sum_lr, n_touch, n_updates):
    """Batched analogue of the per-example scale bump (template:528-534),
    accumulated in log space: ``(1 + alpha*avg_lr)^n_updates`` overflows
    f32 at extreme alpha, ``n_updates * log1p(alpha*avg_lr)`` does not."""
    if not _lazy_reg(hp):
        return state
    avg_lr = sum_lr / torch.clamp(n_touch, min=1.0)
    return state._replace(
        item_log_scale=state.item_log_scale + n_updates * torch.log1p(hp.item_alpha * avg_lr),
        user_log_scale=state.user_log_scale + n_updates * torch.log1p(hp.user_alpha * avg_lr),
    )


def _overflow_chunks(table, acc, mom, feats: ChunkedRows, specs, alpha, kw, placement=None):
    """Apply the over-width feature tail of :class:`ChunkedRows` touches.

    ``specs`` is a list of ``(slots [B], g [B, W], mask [B], first [B])``
    sharing ``feats`` (``first``: each entity's first base-tier feature).
    The chunks apply one after another, each reading the accumulator the
    previous one left, so the working set stays ``[touches, chunk width]``
    however wide the heaviest row is.  ``placement``: the table's, as for
    :func:`_apply_touches`.
    """
    slots = torch.cat([s[0] for s in specs]).long()
    g = torch.cat([s[1] for s in specs])
    mask = torch.cat([s[2] for s in specs])
    first = torch.cat([s[3] for s in specs])[:, None]
    T = slots.shape[0]
    sum_lr = cnt = None
    for idx_c, wts_c in zip(feats.over_idx, feats.over_wts):  # [M+1, C] each
        idx = idx_c[slots]  # [T, C]
        w = wts_c[slots]
        tmask = mask[:, None] & (w != 0)
        idx = _off_row_zero(idx, tmask, first)
        C = idx.shape[1]
        g_flat = g[:, None, :].expand(T, C, g.shape[1]).reshape(T * C, -1)
        idx, tmask, g_flat, own_kw = _own(placement, idx.reshape(-1), tmask.reshape(-1), g_flat)
        table, acc, mom, lr, n = sparse_update(
            table, acc, mom, idx, w.reshape(-1), g_flat, tmask, alpha=alpha, **kw, **own_kw,
        )
        if lr is not None:
            sum_lr, cnt = (lr, n) if sum_lr is None else (sum_lr + lr, cnt + n)
    return table, acc, mom, sum_lr, cnt


def _apply_touches(state, side, feats, touches, over, alpha, kw, placement):
    """One table's sparse optimizer pass (plus its chunked overflow tail)
    on the part this rank holds under ``placement`` (its
    ``TablePlacement``; None: the whole table).  Returns the state and the
    lazy-L2 statistics of the touches applied here."""
    idx, w, g, mask = touches
    observability.count(f"update_touches.{side}", idx.shape[0] + sum(
        s[0].shape[0] * feats.over_idx.shape[2] * feats.n_chunks for s in over))
    idx, mask, g, own_kw = _own(placement, idx, mask, g)
    table, acc, mom, lr, cnt = sparse_update(
        getattr(state, f"{side}_table"), getattr(state, f"{side}_acc"),
        getattr(state, f"{side}_mom"), idx, w, g, mask, alpha=alpha, **kw, **own_kw,
    )
    if over:
        table, acc, mom, lr_o, cnt_o = _overflow_chunks(
            table, acc, mom, feats, over, alpha, kw, placement
        )
        if lr is not None:
            lr, cnt = lr + lr_o, cnt + cnt_o
    state = state._replace(**{f"{side}_table": table, f"{side}_acc": acc, f"{side}_mom": mom})
    return state, (lr, cnt)


def _run_updates(state, hp, item_feats, item_touches, user_feats, user_touches, upd_mask,
                 placement=None):
    """One sparse optimizer pass per table (plus chunked overflow tails),
    then, with L2 on, the scale bump.
    Under a sharded ``placement`` a side's statistics come from the touches
    this rank applied and are summed over the model axis in rank order, so
    every rank bumps the same scales; a replicated side's are every
    touch's already, on every rank, and are not summed."""
    lazy = _lazy_reg(hp)
    kw = dict(
        adadelta=hp.adadelta,
        learning_rate=hp.learning_rate,
        rho=hp.rho,
        eps=hp.epsilon,
        emb_dim=hp.no_components,
        # The scale bump averages lr over BOTH tables' touches.
        need_stats=lazy,
    )
    flat = [t[0] for t in item_touches]
    item_flat = flat[0] if len(flat) == 1 else [torch.cat(parts) for parts in zip(*flat)]
    item_over = [t[1] for t in item_touches if t[1] is not None]
    user_flat, user_over = user_touches
    stats = {}
    with observability.span("step.update"):
        state, stats["item"] = _apply_touches(state, "item", item_feats, item_flat, item_over,
                                              hp.item_alpha, kw, _side(placement, "item"))
        state, stats["user"] = _apply_touches(state, "user", user_feats, user_flat,
                                              [user_over] if user_over is not None else [],
                                              hp.user_alpha, kw, _side(placement, "user"))
    if not lazy:
        return state
    with observability.span("step.l2"):
        split = [s for s in stats
                 if _side(placement, s) is not None and _side(placement, s).sharded]
        if split:
            from lightfm_tpu_torch.parallel.mesh import sum_over_model

            summed = sum_over_model(placement.mesh, *[x for s in split for x in stats[s]])
            stats.update({s: summed[2 * k:2 * k + 2] for k, s in enumerate(split)})
        (lr_i, cnt_i), (lr_u, cnt_u) = stats["item"], stats["user"]
        n_updates = torch.sum(upd_mask.to(torch.float32))
        return _update_scales(state, hp, lr_i + lr_u, cnt_i + cnt_u, n_updates)


def _gather_examples(mesh, *per_example):
    """Under a mesh: every rank's per-example quantities, all-gathered over
    the data axis in rank order (its slices are contiguous columns of the
    batch, so this is the whole batch in order); else as they are."""
    if mesh is None:
        return per_example
    from lightfm_tpu_torch.parallel.mesh import all_gather_rows

    with observability.span("step.gather"):
        return all_gather_rows(mesh, *per_example)


def _apply_pointwise(state, hp, user_feats, item_feats, uid, iid, u_rep, i_rep, loss, upd,
                     mesh=None, placement=None):
    """Gradient step of the logistic loss (``update``, template:454-534):
    item grad = loss * user row, user grad = loss * item row, 1 in the bias
    slot (so ``loss * with_unit_bias(rep)`` is the fused gradient).  Under
    a ``mesh`` the arguments are this rank's slice of the batch; the update
    is the whole batch's, on the part of each table this rank holds under
    ``placement``."""
    uid, iid, u_rep, i_rep, loss, upd = _gather_examples(mesh, uid, iid, u_rep, i_rep, loss, upd)
    with observability.span("step.grads"):
        g_item = loss[:, None] * with_unit_bias(u_rep)
        g_user = loss[:, None] * with_unit_bias(i_rep)
        item_t = _flatten_touches(item_feats, iid, g_item, upd)
        user_t = _flatten_touches(user_feats, uid, g_user, upd)
    return _run_updates(state, hp, item_feats, [item_t], user_feats, user_t, upd, placement)


def _apply_pairwise(state, hp, user_feats, item_feats, uid, pos_iid, neg_iid,
                    u_rep, p_rep, n_rep, loss, upd, mesh=None, placement=None):
    """Gradient step of the ranking losses (``warp_update``,
    template:537-649): positive item -loss * user, negative item +loss *
    user, user loss * (neg - pos); the bias column likewise with 1.  Under
    a ``mesh`` as :func:`_apply_pointwise`."""
    uid, pos_iid, neg_iid, u_rep, p_rep, n_rep, loss, upd = _gather_examples(
        mesh, uid, pos_iid, neg_iid, u_rep, p_rep, n_rep, loss, upd)
    with observability.span("step.grads"):
        lu = loss[:, None] * with_unit_bias(u_rep)
        pos_t = _flatten_touches(item_feats, pos_iid, -lu, upd)
        neg_t = _flatten_touches(item_feats, neg_iid, lu, upd)
        g_user = loss[:, None] * with_unit_bias(n_rep - p_rep)
        user_t = _flatten_touches(user_feats, uid, g_user, upd)
    return _run_updates(state, hp, item_feats, [pos_t, neg_t], user_feats, user_t, upd,
                        placement)


# ---------------------------------------------------------------------------
# Loss steps
# ---------------------------------------------------------------------------


def logistic_step(state: ModelState, batch: Batch, user_feats, item_feats, positives,
                  train_items, hp: Hyperparams, draws=None, mesh=None,
                  placement=None) -> ModelState:
    """Batched sigmoid regression step (``fit_logistic``, template:694-781)."""
    with observability.span("step.score"):
        u_scale, i_scale = _scales(state, hp)
        u_rep = batch_representation(state.user_table, user_feats, batch.user_ids, u_scale,
                                     _side(placement, "user"))
        i_rep = batch_representation(state.item_table, item_feats, batch.item_ids, i_scale,
                                     _side(placement, "item"))
        pred = torch.sigmoid(score_pairs(u_rep, i_rep))
        # Any value <= 0 is a negative interaction (template:751-758).
        y01 = (batch.y > 0).to(torch.float32)
        loss = batch.weight * (pred - y01)
    return _apply_pointwise(state, hp, user_feats, item_feats, batch.user_ids,
                            batch.item_ids, u_rep, i_rep, loss, batch.valid, mesh, placement)


def _pick_flat(reps_flat: torch.Tensor, j: torch.Tensor, B: int) -> torch.Tensor:
    """Row b's ``j[b]``-th slot-major candidate: ``reps_flat[j[b]*B + b]``
    (a plain gather; the JAX package's one-hot sum was a TPU measure)."""
    return reps_flat[j.long() * B + torch.arange(B, device=j.device)]


def _select_slot(arr_kb: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``arr_kb[j[b], b]``."""
    return arr_kb[j.long(), torch.arange(arr_kb.shape[1], device=j.device)]


def _first_true(cand: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 when there is none), as
    ``jnp.argmax`` gives it on a bool array."""
    return torch.argmax(cand.to(torch.int32), dim=dim)


def _rank_weight(j: torch.Tensor, n_items: int) -> torch.Tensor:
    """WARP's rank estimator ``log(max(1, floor((n_items-1)/(j+1))))``
    (template:855-885)."""
    sampled = (j + 1).to(torch.float32)
    return torch.log(torch.clamp(torch.floor((n_items - 1) / sampled), min=1.0))


def _warp_negative_search(state, item_feats, positives, uid, u_rep, pos_pred, neg_ids, hp,
                          placement=None):
    """Score the ``[K, B]`` negative draws at once and select each row's
    first margin violator that is not a positive (template:855-899): a
    violating positive consumes a trial without an update, so it is masked
    out of the candidates but keeps its slot in the draw count."""
    B = uid.shape[0]
    nf_flat, neg_pred = candidate_scores(state.item_table, item_feats, neg_ids, u_rep,
                                         _scales(state, hp)[1], _side(placement, "item"))
    violates = neg_pred > pos_pred[None, :] - 1.0
    cand = violates & ~in_positives_slots(positives, uid, neg_ids)
    found = cand.any(dim=0)
    j = _first_true(cand, 0)
    rank_weight = _rank_weight(j, item_feats.n_rows)
    return _select_slot(neg_ids, j), _pick_flat(nf_flat, j, B), found, rank_weight


def warp_step(state: ModelState, batch: Batch, user_feats, item_feats, positives,
              train_items, hp: Hyperparams, draws: torch.Tensor, mesh=None,
              placement=None) -> ModelState:
    """Batched WARP step (``fit_warp``, template:784-912).  ``draws``: the
    ``[K, B]`` negative item ids.  The positive rides the negatives' gather
    as slot 0 of ``[K+1, B]``."""
    with observability.span("step.score"):
        upd_base = batch.valid & (batch.y > 0)  # template:831
        u_scale, i_scale = _scales(state, hp)
        u_rep = batch_representation(state.user_table, user_feats, batch.user_ids, u_scale,
                                     _side(placement, "user"))

        B = batch.user_ids.shape[0]
        neg_ids = draws.to(batch.item_ids.dtype)
        all_ids = torch.cat([batch.item_ids[None, :], neg_ids], dim=0)
        reps_flat, preds = candidate_scores(state.item_table, item_feats, all_ids, u_rep,
                                            i_scale, _side(placement, "item"))
        pos_pred, neg_pred = preds[0], preds[1:]
        p_rep = reps_flat[:B]

        violates = neg_pred > pos_pred[None, :] - 1.0  # template:875
        cand = violates & ~in_positives_slots(positives, batch.user_ids, neg_ids)  # :878
        found = cand.any(dim=0)
        j = _first_true(cand, 0)
        rank_weight = _rank_weight(j, item_feats.n_rows)
        neg_id = _select_slot(neg_ids, j)
        n_rep = _pick_flat(reps_flat, j + 1, B)

        loss = torch.clamp(batch.weight * rank_weight, max=MAX_LOSS)  # template:881-885
    return _apply_pairwise(state, hp, user_feats, item_feats, batch.user_ids, batch.item_ids,
                           neg_id, u_rep, p_rep, n_rep, loss, upd_base & found, mesh, placement)


def bpr_step(state: ModelState, batch: Batch, user_feats, item_feats, positives,
             train_items, hp: Hyperparams, draws: torch.Tensor, mesh=None,
             placement=None) -> ModelState:
    """Batched BPR step (``fit_bpr``, template:1074-1182).  ``draws``: the
    ``[B, T]`` positions into ``train_items``; negatives come from the
    empirical item distribution (template:1123-1127), rejecting the user's
    positives, and fall through to the last draw."""
    with observability.span("step.score"):
        upd = batch.valid & (batch.y > 0)  # template:1116
        T = draws.shape[1]
        observability.count("bpr_draws", draws.shape[0] * T)
        with observability.span("step.bpr"):
            cand = train_items[draws.long()]  # [B, T]
            ok = ~in_positives(positives, batch.user_ids, cand)
            j = torch.where(ok.any(-1), _first_true(ok, -1), T - 1)
            neg_id = torch.gather(cand, 1, j[:, None])[:, 0]

        u_scale, i_scale = _scales(state, hp)
        u_rep = batch_representation(state.user_table, user_feats, batch.user_ids, u_scale,
                                     _side(placement, "user"))
        B = batch.user_ids.shape[0]
        all_ids = torch.cat([batch.item_ids[None, :], neg_id[None, :].to(batch.item_ids.dtype)],
                            dim=0)
        reps_flat, preds = candidate_scores(state.item_table, item_feats, all_ids, u_rep,
                                            i_scale, _side(placement, "item"))
        p_rep, n_rep = reps_flat[:B], reps_flat[B:]
        loss = batch.weight * (1.0 - torch.sigmoid(preds[0] - preds[1]))  # template:1158
    return _apply_pairwise(state, hp, user_feats, item_feats, batch.user_ids, batch.item_ids,
                           neg_id, u_rep, p_rep, n_rep, loss, upd, mesh, placement)


def kos_slots(u: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """k-OS positive slots from uniforms: ``u`` in [0, 1) of shape
    ``[n, B]`` becomes integers in ``[0, max(lengths, 1))``, guarded
    against the product rounding up to the bound."""
    bound = torch.clamp(lengths.to(torch.int64), min=1)[None, :]
    return torch.minimum((u * bound).to(torch.int64), bound - 1)


def warp_kos_step(state: ModelState, batch: Batch, user_feats, item_feats, positives,
                  train_items, hp: Hyperparams, draws, mesh=None, placement=None) -> ModelState:
    """Batched k-OS WARP step (``fit_warp_kos``, template:915-1071).
    ``draws``: ``(slots [n, B], neg_ids [K, B])``, each slot in ``[0,
    max(#positives, 1))`` of its row.  Samples min(n, #positives) of the
    user's positives with replacement, takes the min(k, #sampled)-th best
    as the positive, then runs the WARP negative search.  No sample
    weights (`lightfm/lightfm.py:385-388`)."""
    with observability.span("step.score"):
        slots, neg_ids = draws
        uid = batch.user_ids
        B = uid.shape[0]
        n_draw = slots.shape[0]
        uid_l = uid.long()
        lens = positives.lengths[uid_l]  # [B]
        upd_base = batch.valid & (lens > 0)  # template:972-973

        u_scale, i_scale = _scales(state, hp)
        u_rep = batch_representation(state.user_table, user_feats, uid, u_scale,
                                     _side(placement, "user"))

        observability.count("kos_draws", n_draw * B)
        with observability.span("step.kos"):
            user_rows = positives.idx[uid_l]  # [B, P] sorted positives
            ar = torch.arange(B, device=uid.device)
            cand = user_rows[ar[None, :], slots.long()]  # [n, B]
            cand = torch.clamp(cand, max=item_feats.n_rows - 1)  # the sentinel of empty rows
            pc_flat, scores = candidate_scores(state.item_table, item_feats, cand, u_rep,
                                               i_scale, _side(placement, "item"))  # [n*B, W]

            no_pos = torch.clamp(lens, max=hp.n)  # template:976
            draw_valid = torch.arange(n_draw, device=uid.device)[:, None] < no_pos[None, :]
            keys = torch.where(draw_valid, -scores, torch.full_like(scores, float("inf")))
            order = torch.argsort(keys, dim=0, stable=True)
            pick = torch.clamp(torch.clamp(no_pos, max=hp.k) - 1, min=0)  # template:1002
            sel = order[pick.long(), ar]

            pos_id = cand[sel, ar]
            pos_pred = scores[sel, ar]
            p_rep = _pick_flat(pc_flat, sel, B)

        neg_id, n_rep, found, rank_weight = _warp_negative_search(
            state, item_feats, positives, uid, u_rep, pos_pred, neg_ids.to(uid.dtype), hp,
            placement,
        )
        loss = torch.clamp(rank_weight, max=MAX_LOSS)  # template:1039-1043 (no weight)
    return _apply_pairwise(state, hp, user_feats, item_feats, uid, pos_id, neg_id,
                           u_rep, p_rep, n_rep, loss, upd_base & found, mesh,
                           placement)


LOSS_STEPS = {
    "logistic": logistic_step,
    "warp": warp_step,
    "bpr": bpr_step,
    "warp-kos": warp_kos_step,
}
