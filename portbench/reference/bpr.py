"""Plain BPR training with adagrad and lazy L2 on both tables, on the
sampling of the port's generic path, in plain PyTorch: the reference that a
one-epoch BPR ``fit_partial`` cell's first steps are held against.

LightFM's BPR step (``fit_bpr``, ``_lightfm_fast.pyx.template:1074-1182``)
as the generic path batches it.  The reference makes each step from the
program's state before it (tables, accumulators and both log scales) and
remakes the epoch's draws from its seed (``warp_kos.epoch_seed``) on the
device, in the program's order: one u32 sort key per padded example (the
global shuffle: a stable sort by key, cut into batches of ``B``), then
``[n_batches, B, T]`` tries, positions into the training interactions in the
order the caller passed them.  ``T`` is :func:`tries_for`'s.  Per step,
users and items are identity rows scaled by ``exp(log_scale)`` (the
lazy-L2 scale, template:287-317):

- the negative: try ``t`` of example ``b`` is the item of interaction
  ``tries[b, t]``, so negatives follow the items' empirical popularity
  (template:1123-1127); the first try that is not one of the user's
  positives (sorted, distinct) is the negative, and where every try is a
  positive the last one is;
- an example updates where it is valid and its value is positive
  (template:1116);
- scores ``dot(user, item)`` plus both biases; the loss ``w * (1 -
  sigmoid(x_pos - x_neg))`` (template:1158), ``w`` the sample weight;
- gradients (``warp_update``, template:537-649): the positive's row takes
  ``-loss * user``, the negative's ``+loss * user``, the user's ``loss *
  (negative - positive)``; the bias column carries 1 in place of the
  user's bias;
- adagrad, one pass a table (template:376-389, 436-449): every touch reads
  the accumulator from before the step, ``lr_local = lr * rsqrt(acc)``;
  the row moves by ``-lr_local`` times its summed gradient and the
  accumulator gains the summed squares; then every touch that updates
  multiplies its row by ``1 + alpha * lr_local``, one float32 multiply
  after another (template:387, 447);
- the scale bump: ``log_scale += n_updates * log1p(alpha * avg_lr)`` on
  each side, ``avg_lr`` the mean ``lr_local`` over both tables' updating
  touches and their active columns (the embedding columns and the bias),
  ``n_updates`` the examples that updated (template:528-534);
- the rescale guard: where either log scale passed ``log(1e6)``, both
  tables are divided by their scales and the scales reset
  (``locked_regularize``, template:678-691).

At the epoch's end both tables are divided by their scales
(``warp_generic.fold``; template:652-675, 1180-1182).

Departures from the source's per-sample Hogwild loop, as the port makes
them: the source draws negatives until one is not a positive of the user
(up to one draw an interaction), where the port draws ``T`` a row and takes
the last where all ``T`` are positives (the port's contract, which this
follows; ``T`` makes that rare, :func:`tries_for`); a step updates a whole
batch at once, so every touch of a step reads the accumulator and the
scales from before the step and duplicate touches of a row sum; the scale
bump uses the step's mean learning rate; the guard runs once a step.

Precision: IEEE float32 for every per-touch value; each row's sums of
touches and the lr statistic are taken in float64 and rounded once
(``"fp32"``); TF32 is off while the reference runs.  ``rounding="bf16"``
rounds the operands of the scores and of the gradients to bfloat16 (the
control, the precision below the configuration's).

Imports neither JAX nor either package of the repository.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.warp import Examples, round_operand
from portbench.reference.warp_generic import MAX_LOG_SCALE
from portbench.reference.warp_kos import (FIELDS, Positives, _active_columns, _row_sum,
                                          _times_per_touch, _unit_bias)

# A user's chance to fall through all ``T`` tries that :func:`tries_for` aims under.
FALL_THROUGH = 1e-3


def tries_for(coo) -> int:
    """``T``, the tries a row: the least power of two in ``[8, 64]`` at
    which the user whose positives carry the largest share ``p`` of the
    interactions (each distinct positive weighted by its item's count of
    distinct users) falls through all of them less than ``FALL_THROUGH``
    of the time (``p ** T``), with ``p`` capped at 0.99."""
    if coo.nnz == 0:
        return 8
    n_items = coo.shape[1]
    keys = np.unique(coo.row.astype(np.int64) * n_items + coo.col)
    users, items = keys // n_items, keys % n_items
    users_of_item = np.bincount(items, minlength=n_items).astype(np.float64)
    p = min(float(np.bincount(users, weights=users_of_item[items]).max()) / coo.nnz, 0.99)
    if p <= 0:
        return 8
    need = math.ceil(math.log(FALL_THROUGH) / math.log(p)) if p > FALL_THROUGH else 1
    T = 8
    while T < need and T < 64:
        T *= 2
    return T


def _adagrad_l2(table, acc, rows, g, active, lr: float, alpha: float, act_cols):
    """One table's adagrad pass over its touches ``rows`` (flat) with
    gradients ``g`` (masked touches carry zeros) and ``active`` flags, then
    the L2 multiply; returns the sum of ``lr_local`` over active touches
    and active columns, and the count of those pairs."""
    n = table.shape[0]
    count = torch.zeros(n, dtype=torch.int64, device=table.device).index_add_(
        0, rows, active.to(torch.int64))
    lr_row = lr * torch.rsqrt(acc)  # the accumulator before the step
    table.copy_((table.double() - lr_row.double() * _row_sum(n, rows, g)).float())
    acc.copy_((acc.double() + _row_sum(n, rows, g * g)).float())
    if alpha != 0.0:
        _times_per_touch(table, count, 1.0 + alpha * lr_row)
    sum_lr = float((count[:, None].double() * (lr_row * act_cols[None, :]).double()).sum())
    return sum_lr, float(count.sum()) * float(act_cols.sum())


def bpr_step(tab: dict, pos: Positives, train_items, uid, iid, y, w, valid, tries, *, D: int,
             lr: float, item_alpha: float, user_alpha: float, rounding: str = "fp32") -> dict:
    """One generic BPR step over a batch, updating ``tab`` in place.
    ``tries``: ``[B, T]`` positions into ``train_items``.  Returns the
    step's picks: each example's positive and negative item ids and
    whether it updated."""
    r = (lambda x: round_operand(x, rounding))
    B, T = tries.shape
    dev = uid.device
    it, ut = tab["item_table"], tab["user_table"]
    W = it.shape[1]
    i_scale = torch.exp(tab["item_log_scale"])
    u_scale = torch.exp(tab["user_log_scale"])

    cand = train_items[tries]  # [B, T]
    ok = ~pos.contain(uid, cand.T.contiguous()).T
    ts = torch.arange(T, device=dev)[None, :].expand(B, T)
    j = torch.where(ok, ts, torch.full_like(ts, T)).min(1).values
    j = torch.where(j < T, j, torch.full_like(j, T - 1))
    neg = cand[torch.arange(B, device=dev), j]
    upd = valid & (y > 0)

    u = ut[uid] * u_scale
    u1 = r(_unit_bias(u))
    p_rep, n_rep = it[iid] * i_scale, it[neg] * i_scale
    x_pos = (u1 * r(p_rep)).sum(-1) + u[:, -1]
    x_neg = (u1 * r(n_rep)).sum(-1) + u[:, -1]
    loss = torch.where(upd, w * (1.0 - torch.sigmoid(x_pos - x_neg)), torch.zeros_like(w))

    lu = r(loss[:, None] * u1)
    g_user = r(loss[:, None] * _unit_bias(n_rep - p_rep))
    act_cols = _active_columns(D, W, dev)
    t_rows = torch.cat([iid, neg])
    t_active = torch.cat([upd, upd])
    t_g = torch.where(t_active[:, None], torch.cat([-lu, lu]), torch.zeros((2 * B, W), device=dev))
    lr_i, n_i = _adagrad_l2(it, tab["item_acc"], t_rows, t_g, t_active, lr, item_alpha,
                            act_cols)
    g_user = torch.where(upd[:, None], g_user, torch.zeros_like(g_user))
    lr_u, n_u = _adagrad_l2(ut, tab["user_acc"], uid, g_user, upd, lr, user_alpha, act_cols)

    if item_alpha != 0.0 or user_alpha != 0.0:
        avg_lr = torch.tensor((lr_i + lr_u) / max(n_i + n_u, 1.0), dtype=torch.float32,
                              device=dev)
        n_updates = upd.sum().to(torch.float32)
        tab["item_log_scale"] = tab["item_log_scale"] + n_updates * torch.log1p(
            item_alpha * avg_lr)
        tab["user_log_scale"] = tab["user_log_scale"] + n_updates * torch.log1p(
            user_alpha * avg_lr)
        if max(float(tab["item_log_scale"]), float(tab["user_log_scale"])) > MAX_LOG_SCALE:
            it *= torch.exp(-tab["item_log_scale"])
            ut *= torch.exp(-tab["user_log_scale"])
            tab["item_log_scale"] = torch.zeros_like(tab["item_log_scale"])
            tab["user_log_scale"] = torch.zeros_like(tab["user_log_scale"])
    return {"pos_id": iid.cpu(), "neg_id": neg.cpu(), "upd": upd.cpu()}


def first_steps(coo, states: dict, *, seed: int, D: int, lr: float, item_alpha: float,
                user_alpha: float, batch_size: int, steps, device,
                rounding: str = "fp32") -> dict:
    """Steps of the epoch seeded by ``seed`` over ``coo``, each from the
    program's own state: ``states[s]`` holds the ``FIELDS`` before step
    ``s + 1`` (on any device).  Returns ``{step: state on the CPU}`` for
    each step in ``steps`` (0 is ``states[0]``; step ``s`` is step ``s``
    made from ``states[s - 1]``), ``"picks"``, step 1's picks
    (:func:`bpr_step`), and ``"tries"``, :func:`tries_for`'s ``T``."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _first_steps(coo, states, seed, D, lr, item_alpha, user_alpha, batch_size, steps,
                            device, rounding)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def _first_steps(coo, states, seed, D, lr, item_alpha, user_alpha, batch_size, steps, device,
                 rounding):
    T = tries_for(coo)
    pos = Positives(coo, device)
    train_items = torch.as_tensor(coo.col.astype(np.int64), device=device)
    ex = Examples(coo, batch_size)
    n_batches = ex.n_pad // batch_size
    last = max(steps)
    if last > n_batches:
        raise ValueError(f"step {last} is past the epoch's {n_batches} steps")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    perm = torch.randint(0, 1 << 32, (ex.n_pad,), generator=gen, device=device,
                         dtype=torch.int64)
    tries = torch.randint(0, coo.nnz, (n_batches, batch_size, T), generator=gen, device=device)
    order = torch.sort(perm, stable=True).indices.cpu().numpy()

    def put(a, b):
        return torch.as_tensor(a[order[b * batch_size:(b + 1) * batch_size]], device=device)

    out = {0: {f: states[0][f].to("cpu", torch.float32, copy=True) for f in FIELDS},
           "tries": T}
    for b in range(last):
        tab = {f: states[b][f].to(device, torch.float32, copy=True) for f in FIELDS}
        picks = bpr_step(tab, pos, train_items, put(ex.user, b), put(ex.item, b), put(ex.y, b),
                         put(ex.w, b), put(ex.valid, b), tries[b], D=D, lr=lr,
                         item_alpha=item_alpha, user_alpha=user_alpha, rounding=rounding)
        if b == 0:
            out["picks"] = picks
        if b + 1 in steps:
            out[b + 1] = {f: v.to("cpu", copy=True) for f, v in tab.items()}
    return out


def change_gap(prog: dict, ref: dict, D: int, W: int, step: int = 1) -> float:
    """``warp_kos.change_gap``'s measure over the tables and accumulators:
    the worst over both sides, ``table`` and ``acc`` and the embedding and
    bias columns of ``||prog[step] - ref[step]|| / ||ref[step] - prog[step -
    1]||``, leaving out a leaf whose reference change is under a thousandth
    of the median leaf's.  Each accumulator entry's difference counts less
    one float32 ulp of the reference's entry: the accumulator is stored in
    float32, and the program's float32 sum of a row's squares and the exact
    one, each added to it with one rounding, land one ulp apart where they
    straddle one of its rounding boundaries.  A hot item's accumulator grows
    to thousands while a step adds far less, so that one ulp can be a
    tenth of a thousandth of the whole leaf's change."""
    gaps, sizes = {}, {}
    for side in ("item", "user"):
        for f in ("table", "acc"):
            key = f"{side}_{f}"
            for leaf, cols in (("emb", slice(0, D)), ("bias", slice(W - 1, W))):
                want = ref[step][key][:, cols].float()
                diff = (prog[step][key][:, cols].double() - want.double()).abs()
                if f == "acc":
                    up = torch.nextafter(want.abs(), torch.full_like(want, np.inf))
                    diff = torch.clamp(diff - (up - want.abs()).double(), min=0.0)
                change = want.double() - prog[step - 1][key][:, cols].double()
                sizes[key, leaf] = float(torch.linalg.vector_norm(change))
                gaps[key, leaf] = float(torch.linalg.vector_norm(diff))
    med = float(np.median(list(sizes.values())))
    return max(gaps[x] / sizes[x] for x in sizes if sizes[x] > 0 and sizes[x] >= 1e-3 * med)


def pick_mismatch(prog: dict, ref: dict) -> float:
    """The share of the batch's examples whose negative or update decision
    differs in ``prog`` (the same keys as :func:`bpr_step`'s picks, over the
    same batch)."""
    differ = ((prog["upd"].bool() != ref["upd"].bool())
              | (prog["neg_id"].long() != ref["neg_id"].long()))
    return float(differ.sum()) / max(int(differ.numel()), 1)
