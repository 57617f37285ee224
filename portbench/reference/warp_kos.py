"""Plain k-OS WARP training with adadelta and lazy L2 on both tables, on
the sampling of the port's generic path, in plain PyTorch: the reference
that a one-epoch ``fit_partial`` cell's first steps are held against.

LightFM's k-OS step (``fit_warp_kos``, ``_lightfm_fast.pyx.template:915-1071``)
as the generic path batches it.  The reference makes each step from the
program's state before it (tables, accumulators, moments and both log
scales) and remakes the epoch's draws from its seed (:func:`epoch_seed`)
on the device, in the program's order: one u32 sort key per padded
example (the global shuffle: a stable sort by key, cut into batches of
``B``), then ``[n_batches, n, B]`` uniforms, then ``[n_batches, K, B]``
negative item ids.  Per step, users and items are identity rows scaled by
``exp(log_scale)`` (the lazy-L2 scale, template:287-317):

- each example's user has ``len`` distinct positives, sorted by item id;
  uniform ``u`` of draw ``d`` takes slot ``min(floor(u * len), len - 1)``
  (``len`` at least 1);
- the first ``min(n, len)`` draws are scored (``dot(user, item)`` plus both
  biases), ordered by score, best first, and the ``min(k, min(n, len))``-th
  is the example's positive (template:969-1003);
- the ``K`` negatives are scored and the first that violates the margin
  (score above the positive's minus 1) and is not one of the user's
  positives is the violator, with rank weight ``log(max(floor((n_items -
  1) / (j + 1)), 1))`` and the loss clipped at 10 (no sample weight,
  template:1005-1043); an example updates where it is valid, its user has
  a positive and a violator was found;
- gradients (``warp_update``, template:537-649): the positive's row takes
  ``-loss * user``, the violator's ``+loss * user``, the user's ``loss *
  (violator - positive)``; the bias column carries 1 in place of the
  user's bias;
- adadelta, one pass a table (template:359-374, 417-434): ``acc`` decays
  by ``rho`` once per unmasked touch of its row and gains ``(1 - rho) *
  g^2`` summed over them; ``lr_local = sqrt(mom + eps) / sqrt(acc + eps)``
  reads the updated ``acc`` and the moment from before the step; ``mom``
  decays likewise and gains ``(1 - rho) * update^2``, ``update = lr_local
  * g``; the row moves by ``-update`` summed; then every unmasked touch
  multiplies its row by ``1 + alpha * lr_local`` (template:372, 432);
- the scale bump: ``log_scale += n_updates * log1p(alpha * avg_lr)`` on
  each side, ``avg_lr`` the mean ``lr_local`` over both tables' unmasked
  touches and their active columns (the embedding columns and the bias),
  ``n_updates`` the examples that updated (template:528-534);
- the rescale guard: where either log scale passed ``log(1e6)``, both
  tables are divided by their scales and the scales reset
  (``locked_regularize``, template:678-691).

At the epoch's end both tables are divided by their scales
(``warp_generic.fold``; template:652-675, 1069-1071).

Departures from the per-sample template, as the port makes them: a step
updates a whole batch at once, so all of a row's touches in a step decay
its ``acc`` and ``mom`` before any of them reads ``lr_local`` (the template
decays, adds and reads touch by touch), and every touch of a row in a step
reads the same ``lr_local``; duplicate touches of a row sum; the template
draws positives by ``sample_range`` and sorts them with ``qsort``, which
leaves the order of equal scores open, where this takes the earlier draw
first; the scale bump uses the step's mean learning rate and the guard
runs once a step.

Precision: IEEE float32 for every per-touch value, with each row's sums of
touches taken in float64 and rounded once (``"fp32"``); TF32 is off while
the reference runs.  ``rounding="bf16"`` rounds the operands of the scores
and of the gradients to bfloat16 (the control, the precision below the
configuration's).

Imports neither JAX nor either package of the repository.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.warp import Examples, round_operand
from portbench.reference.warp_generic import FOLD_FIELDS, MAX_LOG_SCALE, MAX_LOSS, fold, fold_gap

# The state a step reads and writes, in the order the program's state holds it.
FIELDS = ("item_table", "item_acc", "item_mom", "user_table", "user_acc", "user_mom",
          "item_log_scale", "user_log_scale")
# The fields whose change after step 1 ``change1_norm_gap`` compares.
CHANGED = ("table", "acc", "mom")

__all__ = ["FIELDS", "FOLD_FIELDS", "epoch_seed", "first_steps", "change_gap", "pick_mismatch",
           "fold", "fold_gap"]


def epoch_seed(model_seed: int, calls) -> int:
    """The epoch seed of a one-epoch ``fit_partial`` made after ``calls``
    (each ``"fit"`` or ``"fit_partial"``, one epoch each) on a model built
    with ``random_state=model_seed``: a ``fit`` draws its state's seed and
    then its epoch's from the model's ``RandomState``, a ``fit_partial``
    its epoch's alone."""
    rs = np.random.RandomState(model_seed)
    top = np.iinfo(np.int32).max
    for kind in calls:
        if kind == "fit":
            rs.randint(0, top)
        rs.randint(0, top, size=1)
    return int(rs.randint(0, top, size=1).astype(np.uint32)[0])


class Positives:
    """Each user's distinct positives, sorted by item id, as one flat array
    with its row starts and lengths on ``device``; ``keys`` are the sorted
    ``user * n_items + item``."""

    def __init__(self, coo, device):
        n_users, n_items = coo.shape
        keys = np.unique(coo.row.astype(np.int64) * n_items + coo.col)
        users = keys // n_items
        lengths = np.bincount(users, minlength=n_users)
        self.items = torch.as_tensor(keys % n_items, device=device)
        self.lengths = torch.as_tensor(lengths, device=device)
        self.start = torch.as_tensor(np.cumsum(lengths) - lengths, device=device)
        self.keys = torch.as_tensor(keys, device=device)
        self.n_items = n_items

    def contain(self, uid, items):
        """Whether each ``items[k, b]`` is a positive of user ``uid[b]``."""
        want = uid[None, :] * self.n_items + items
        at = torch.searchsorted(self.keys, want).clamp(max=self.keys.shape[0] - 1)
        return self.keys[at] == want


def _unit_bias(x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    out[..., -1] = 1.0
    return out


def _active_columns(D: int, W: int, device) -> torch.Tensor:
    cols = torch.arange(W, device=device)
    return ((cols < D) | (cols == W - 1)).to(torch.float32)


def _row_sum(n: int, rows, values) -> torch.Tensor:
    """``[n, W]`` float64 sums of ``values`` over ``rows``."""
    return torch.zeros((n, values.shape[1]), dtype=torch.float64,
                       device=values.device).index_add_(0, rows, values.double())


def _times_per_touch(x: torch.Tensor, count: torch.Tensor, factor) -> None:
    """``x[r] *= factor[r]`` once for each of row ``r``'s ``count[r]``
    touches, one multiply after another in float32."""
    for t in range(int(count.max()) if count.numel() else 0):
        rows = count > t
        x[rows] *= factor[rows] if isinstance(factor, torch.Tensor) else factor


def _adadelta_l2(table, acc, mom, rows, g, active, rho: float, eps: float, alpha: float,
                 act_cols):
    """One table's adadelta pass over its touches ``rows`` (flat) with
    gradients ``g`` (masked touches carry zeros) and ``active`` flags, then
    the L2 multiply; returns the sum of ``lr_local`` over active touches
    and active columns, and the count of those pairs."""
    n = table.shape[0]
    count = torch.zeros(n, dtype=torch.int64, device=table.device).index_add_(
        0, rows, active.to(torch.int64))
    _times_per_touch(acc, count, rho)
    acc.copy_((acc.double() + _row_sum(n, rows, (1.0 - rho) * (g * g))).float())
    lr_row = torch.sqrt(mom + eps) / torch.sqrt(acc + eps)
    update = lr_row[rows] * g
    _times_per_touch(mom, count, rho)
    mom.copy_((mom.double() + _row_sum(n, rows, (1.0 - rho) * (update * update))).float())
    table.copy_((table.double() - _row_sum(n, rows, update)).float())
    if alpha != 0.0:
        _times_per_touch(table, count, 1.0 + alpha * lr_row)
    sum_lr = float((count[:, None].double() * (lr_row * act_cols[None, :]).double()).sum())
    return sum_lr, float(count.sum()) * float(act_cols.sum())


def kos_step(tab: dict, pos: Positives, uid, valid, u_draw, neg, *, D: int, k: int,
             rho: float, eps: float, item_alpha: float, user_alpha: float,
             rounding: str = "fp32") -> dict:
    """One generic k-OS step over a batch, updating ``tab`` in place.
    ``u_draw``: ``[n, B]`` uniforms; ``neg``: ``[K, B]`` negative item ids.
    Returns the step's picks: each example's positive and violator item
    ids and whether it updated."""
    r = (lambda x: round_operand(x, rounding))
    n_draw, B = u_draw.shape
    K = neg.shape[0]
    dev = uid.device
    cols = torch.arange(B, device=dev)
    it, ut = tab["item_table"], tab["user_table"]
    W = it.shape[1]
    i_scale = torch.exp(tab["item_log_scale"])
    u_scale = torch.exp(tab["user_log_scale"])

    u = ut[uid] * u_scale
    u1 = r(_unit_bias(u))

    def scores(ids):
        reps = it[ids] * i_scale  # [C, B, W]
        return reps, (u1[None] * r(reps)).sum(-1) + u[:, -1][None]

    lens = pos.lengths[uid]
    bound = torch.clamp(lens, min=1)
    slot = torch.minimum(torch.floor(u_draw * bound.float()).long(), bound - 1)
    at = torch.clamp(pos.start[uid] + slot, max=pos.items.shape[0] - 1)
    cand = pos.items[at]  # [n, B]
    cand_reps, cand_pred = scores(cand)
    n_valid = torch.clamp(lens, max=n_draw)
    drawn = torch.arange(n_draw, device=dev)[:, None] < n_valid[None, :]
    order = torch.argsort(torch.where(drawn, -cand_pred, torch.full_like(cand_pred, np.inf)),
                          dim=0, stable=True)
    sel = order[torch.clamp(torch.clamp(n_valid, max=k) - 1, min=0), cols]
    pos_id, pos_pred, p_rep = cand[sel, cols], cand_pred[sel, cols], cand_reps[sel, cols]

    neg_reps, neg_pred = scores(neg)
    ok = (neg_pred > pos_pred[None, :] - 1.0) & ~pos.contain(uid, neg)
    ks = torch.arange(K, device=dev)[:, None].expand(K, B)
    j = torch.where(ok, ks, torch.full_like(ks, K)).min(0).values
    found = j < K
    j = torch.where(found, j, torch.zeros_like(j))
    rank_weight = torch.log(torch.clamp(torch.floor((pos.n_items - 1) / (j + 1).float()),
                                        min=1.0))
    upd = valid & (lens > 0) & found
    loss = torch.where(upd, torch.clamp(rank_weight, max=MAX_LOSS), torch.zeros_like(rank_weight))
    neg_id, n_rep = neg[j, cols], neg_reps[j, cols]

    lu = r(loss[:, None] * u1)
    g_user = r(loss[:, None] * _unit_bias(n_rep - p_rep))
    act_cols = _active_columns(D, W, dev)
    t_rows = torch.cat([pos_id, neg_id])
    t_active = torch.cat([upd, upd])
    t_g = torch.where(t_active[:, None], torch.cat([-lu, lu]), torch.zeros((2 * B, W), device=dev))
    lr_i, n_i = _adadelta_l2(it, tab["item_acc"], tab["item_mom"], t_rows, t_g, t_active, rho,
                             eps, item_alpha, act_cols)
    g_user = torch.where(upd[:, None], g_user, torch.zeros_like(g_user))
    lr_u, n_u = _adadelta_l2(ut, tab["user_acc"], tab["user_mom"], uid, g_user, upd, rho, eps,
                             user_alpha, act_cols)

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
    return {"pos_id": pos_id.cpu(), "neg_id": neg_id.cpu(), "upd": upd.cpu()}


def first_steps(coo, states: dict, *, seed: int, D: int, K: int, k: int, n: int, rho: float,
                eps: float, item_alpha: float, user_alpha: float, batch_size: int, steps,
                device, rounding: str = "fp32") -> dict:
    """Steps of the epoch seeded by ``seed`` over ``coo``, each from the
    program's own state: ``states[s]`` holds the :data:`FIELDS` before
    step ``s + 1`` (on any device).  Returns ``{step: state on the CPU}``
    for each step in ``steps`` (0 is ``states[0]``; step ``s`` is step ``s``
    made from ``states[s - 1]``), and ``"picks"``, step 1's picks
    (:func:`kos_step`).  Each step starts where the program's did, so a
    margin decision that float32 order flips in one step does not carry
    into the next one's comparison."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _first_steps(coo, states, seed, D, K, k, n, rho, eps, item_alpha, user_alpha,
                            batch_size, steps, device, rounding)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def _first_steps(coo, states, seed, D, K, k, n, rho, eps, item_alpha, user_alpha, batch_size,
                 steps, device, rounding):
    n_items = coo.shape[1]
    pos = Positives(coo, device)
    ex = Examples(coo, batch_size)
    n_batches = ex.n_pad // batch_size
    last = max(steps)
    if last > n_batches:
        raise ValueError(f"step {last} is past the epoch's {n_batches} steps")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    perm = torch.randint(0, 1 << 32, (ex.n_pad,), generator=gen, device=device,
                         dtype=torch.int64)
    u_draw = torch.rand((n_batches, n, batch_size), generator=gen, device=device)
    negs = torch.randint(0, n_items, (n_batches, K, batch_size), generator=gen, device=device)
    order = torch.sort(perm, stable=True).indices.cpu().numpy()

    def put(a, b):
        return torch.as_tensor(a[order[b * batch_size:(b + 1) * batch_size]], device=device)

    out = {0: {f: states[0][f].to("cpu", torch.float32, copy=True) for f in FIELDS}}
    for b in range(last):
        tab = {f: states[b][f].to(device, torch.float32, copy=True) for f in FIELDS}
        picks = kos_step(tab, pos, put(ex.user, b), put(ex.valid, b), u_draw[b], negs[b], D=D,
                         k=k, rho=rho, eps=eps, item_alpha=item_alpha, user_alpha=user_alpha,
                         rounding=rounding)
        if b == 0:
            out["picks"] = picks
        if b + 1 in steps:
            out[b + 1] = {f: v.to("cpu", copy=True) for f, v in tab.items()}
    return out


def change_gap(prog: dict, ref: dict, D: int, W: int, step: int = 1) -> float:
    """The worst over both sides, :data:`CHANGED` and the embedding and bias
    columns of ``||prog[step] - ref[step]|| / ||ref[step] - prog[step - 1]||``:
    the relative norm of the difference of the two changes, as both start
    from ``prog[step - 1]``.  A leaf whose reference change is under a
    thousandth of the median leaf's is left out."""
    gaps, sizes = {}, {}
    for side in ("item", "user"):
        for f in CHANGED:
            key = f"{side}_{f}"
            for leaf, cols in (("emb", slice(0, D)), ("bias", slice(W - 1, W))):
                want = ref[step][key][:, cols].double()
                change = want - prog[step - 1][key][:, cols].double()
                diff = prog[step][key][:, cols].double() - want
                sizes[key, leaf] = float(torch.linalg.vector_norm(change))
                gaps[key, leaf] = float(torch.linalg.vector_norm(diff))
    med = float(np.median(list(sizes.values())))
    return max(gaps[x] / sizes[x] for x in sizes if sizes[x] > 0 and sizes[x] >= 1e-3 * med)


def pick_mismatch(prog: dict, ref: dict) -> float:
    """The share of the reference's updating examples whose update
    decision, positive or violator differs in ``prog`` (the same keys as
    :func:`kos_step`'s picks, over the same batch)."""
    up, ur = prog["upd"].bool(), ref["upd"].bool()
    differ = (up != ur) | (ur & ((prog["pos_id"].long() != ref["pos_id"].long())
                                 | (prog["neg_id"].long() != ref["neg_id"].long())))
    return float(differ.sum()) / max(int(ur.sum()), 1)
