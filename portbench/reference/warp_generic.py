"""Plain WARP training with adagrad and lazy L2 over item features, on the
sampling of the port's generic path, in plain PyTorch: the reference that
a generic fit cell's first steps are held against.

LightFM's WARP step (``_lightfm_fast.pyx.template:784-912``) as the generic
path batches it.  Every epoch draws, from a generator seeded with the
epoch's seed, one u32 sort key per padded example (the global shuffle: a
stable sort by key, cut into batches of ``B``) and then ``[n_batches, K,
B]`` negative item ids, candidate ``k`` of example ``b``.  Per step:

- representations are feature sums: item ``i`` is ``sum_f w_if
  table[f]`` over its features, scaled by ``exp(item_log_scale)``; users
  are identity rows scaled by ``exp(user_log_scale)`` (the lazy-L2 scale,
  template:287-317);
- each example scores its positive and its ``K`` candidates (``dot(user,
  item) + both biases``), takes the first candidate that violates the
  margin (score above the positive's minus 1) and is not one of the
  user's positives, with rank weight ``log(max(floor((n_items - 1) / (j
  + 1)), 1))`` and the loss (sample weight times rank weight) clipped at
  10; examples with no violator, no positive value or padding do not
  update;
- gradients: each feature row of the positive takes ``-loss * user`` and
  each of the violator's ``+loss * user``, times the feature's raw weight;
  the user row takes ``loss * (violator - positive)``; the bias column
  carries 1 in place of the user's bias (``warp_update``,
  template:537-649);
- adagrad, one pass a table: every touch reads the accumulator as it was
  before the step, ``lr_local = lr / sqrt(acc)``; the table moves by
  ``-lr_local`` times the row's summed gradient, the accumulator gains the
  summed squares; then every active touch multiplies its row by ``1 +
  alpha * lr_local`` (template:372-389, 432-449);
- the scale bump: ``log_scale += n_updates * log1p(alpha * avg_lr)``, with
  ``avg_lr`` the mean ``lr_local`` over both tables' active touches and
  their active columns (the embedding columns and the bias) and
  ``n_updates`` the examples that updated (template:528-534);
- the rescale guard: where either log scale passed ``log(1e6)``, both
  tables are divided by their scales and the scales reset
  (``locked_regularize``, template:678-691).

At an epoch's end both tables are divided by their scales and the scales
reset (:func:`fold`; ``regularize``, template:652-675, 779-781, 910-912).

Departures from the source's per-sample Hogwild loop, as the port makes
them: a step updates a whole batch at once, so every touch of a step reads
the accumulator and the scales from before the step and duplicate touches
of a row sum; the scale bump uses the step's mean learning rate; the guard
runs once a step.  Users are identity features.

Precision: IEEE float32 throughout (``"fp32"``; no matrix product is used,
and TF32 is switched off while the reference runs all the same).  ``rounding="bf16"`` rounds the operands of the
representations, scores and gradients to bfloat16 (the control, the
precision below the configuration's).  Random draws (initial tables, sort
keys, negatives) are made from the model's seed as the program's
documented draws make them.

Imports neither JAX nor either package of the repository.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.warp import Examples, init_tables, round_operand

MAX_LOSS = 10.0
MAX_LOG_SCALE = math.log(1e6)
# The state the end-of-epoch fold reads and writes.
FOLD_FIELDS = ("item_table", "user_table", "item_log_scale", "user_log_scale")


class Features:
    """A CSR feature matrix as ``[n_rows, width]`` ids and weights on
    ``device``, padded with weight 0 to its longest row."""

    def __init__(self, csr, device):
        csr = csr.tocsr()
        lengths = np.diff(csr.indptr)
        width = max(int(lengths.max()) if len(lengths) else 1, 1)
        idx = np.zeros((csr.shape[0], width), np.int64)
        wts = np.zeros((csr.shape[0], width), np.float32)
        slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], lengths)
        rows = np.repeat(np.arange(csr.shape[0]), lengths)
        idx[rows, slot] = csr.indices
        wts[rows, slot] = csr.data
        self.idx = torch.as_tensor(idx, device=device)
        self.wts = torch.as_tensor(wts, device=device)
        self.n_features = csr.shape[1]


def _unit_bias(x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    out[..., -1] = 1.0
    return out


def _active_columns(D: int, W: int, device) -> torch.Tensor:
    cols = torch.arange(W, device=device)
    return ((cols < D) | (cols == W - 1)).to(torch.float32)


def _adagrad_l2(table, acc, rows, wg, active, lr: float, alpha: float, act_cols):
    """One table's pass over its touches ``rows`` (flat) with gradients
    ``wg`` (masked touches carry zeros) and ``active`` flags; returns the
    sum of ``lr_local`` over active touches and active columns, and the
    count of those pairs."""
    n, W = table.shape
    lr_row = lr * torch.rsqrt(acc)  # the accumulator before the step
    S1 = torch.zeros_like(table).index_add_(0, rows, wg)
    S2 = torch.zeros_like(table).index_add_(0, rows, wg * wg)
    count = torch.zeros(n, dtype=torch.float64, device=table.device).index_add_(
        0, rows, active.to(torch.float64))
    table -= lr_row * S1
    acc += S2
    if alpha != 0.0:
        factor = (1.0 + alpha * lr_row).double()  # rounded to float32 first
        table.copy_((table.double() * factor ** count[:, None]).float())
    sum_lr = float((count[:, None] * (lr_row * act_cols[None, :]).double()).sum())
    return sum_lr, float(count.sum()) * float(act_cols.sum())


def warp_step(tab: dict, feats: Features, uid, iid, y, w, valid, neg, pos_keys,
              n_items: int, D: int, lr: float, item_alpha: float, user_alpha: float,
              rounding: str):
    """One generic WARP step over a batch, updating ``tab`` in place.
    ``neg``: ``[K, B]`` negative item ids; ``pos_keys``: sorted ``user *
    n_items + item`` of the distinct train positives."""
    r = (lambda x: round_operand(x, rounding))
    K, B = neg.shape
    dev = uid.device
    it, ut = tab["item_table"], tab["user_table"]
    W = it.shape[1]
    lazy = item_alpha != 0.0 or user_alpha != 0.0
    i_scale = torch.exp(tab["item_log_scale"]) if lazy else torch.ones((), device=dev)
    u_scale = torch.exp(tab["user_log_scale"]) if lazy else torch.ones((), device=dev)

    u = ut[uid] * u_scale
    u1 = _unit_bias(u)
    ids = torch.cat([iid[None, :], neg], 0)  # [K + 1, B]
    fidx, fw = feats.idx[ids], feats.wts[ids]  # [K + 1, B, P]
    reps = (r(fw * i_scale)[..., None] * r(it[fidx])).sum(-2)  # [K + 1, B, W]
    preds = (r(u1)[None] * r(reps)).sum(-1) + u[:, -1][None]
    pos_pred, neg_pred = preds[0], preds[1:]

    keys = uid[None, :] * n_items + neg
    at = torch.searchsorted(pos_keys, keys).clamp(max=pos_keys.shape[0] - 1)
    ok = (neg_pred > pos_pred[None, :] - 1.0) & ~(pos_keys[at] == keys)
    ks = torch.arange(K, device=dev)[:, None].expand(K, B)
    j = torch.where(ok, ks, torch.full_like(ks, K)).min(0).values
    found = j < K
    j = torch.where(found, j, torch.zeros_like(j))
    rank_weight = torch.log(torch.clamp(torch.floor((n_items - 1) / (j + 1).float()), min=1.0))
    loss = torch.clamp(w * rank_weight, max=MAX_LOSS)
    upd = valid & (y > 0) & found
    lossm = torch.where(upd, loss, torch.zeros_like(loss))

    cols = torch.arange(B, device=dev)
    p_rep, n_rep = reps[0], reps[1 + j, cols]
    lu = r(lossm[:, None] * u1)  # [B, W]
    g_user = r(lossm[:, None] * _unit_bias(n_rep - p_rep))

    # Item touches: the positive's features, then the violator's.
    t_rows = torch.cat([fidx[0], fidx[1 + j, cols]], 0).reshape(-1)  # [2 B P]
    t_w = torch.cat([fw[0], fw[1 + j, cols]], 0)  # [2 B, P]
    t_active = (torch.cat([upd, upd], 0)[:, None] & (t_w != 0)).reshape(-1)
    t_g = torch.cat([-lu, lu], 0)[:, None, :] * t_w[..., None]  # [2 B, P, W]
    t_g = torch.where(t_active[:, None], t_g.reshape(-1, W), torch.zeros_like(t_g.reshape(-1, W)))
    act_cols = _active_columns(D, W, dev)
    lr_i, n_i = _adagrad_l2(it, tab["item_acc"], t_rows, t_g, t_active, lr, item_alpha,
                            act_cols)
    g_user = torch.where(upd[:, None], g_user, torch.zeros_like(g_user))
    lr_u, n_u = _adagrad_l2(ut, tab["user_acc"], uid, g_user, upd, lr, user_alpha, act_cols)

    if not lazy:
        return
    avg_lr = torch.tensor((lr_i + lr_u) / max(n_i + n_u, 1.0), dtype=torch.float32,
                          device=dev)
    n_updates = upd.sum().to(torch.float32)
    tab["item_log_scale"] = tab["item_log_scale"] + n_updates * torch.log1p(item_alpha * avg_lr)
    tab["user_log_scale"] = tab["user_log_scale"] + n_updates * torch.log1p(user_alpha * avg_lr)
    if max(float(tab["item_log_scale"]), float(tab["user_log_scale"])) > MAX_LOG_SCALE:
        it *= torch.exp(-tab["item_log_scale"])
        ut *= torch.exp(-tab["user_log_scale"])
        tab["item_log_scale"] = torch.zeros_like(tab["item_log_scale"])
        tab["user_log_scale"] = torch.zeros_like(tab["user_log_scale"])


def first_steps(coo, item_features, *, D: int, W: int, K: int, lr: float, item_alpha: float,
                user_alpha: float, batch_size: int, model_seed: int, epochs: int, steps,
                device, rounding: str = "fp32", fits_before: int = 0) -> dict:
    """The state ``{step: tables, accumulators and log scales on the CPU}``
    after each step in ``steps`` (0 is the initial state) of the first
    epoch of a fit of ``coo`` with ``item_features`` (a CSR matrix, items
    by features) and identity users, made after ``fits_before`` fits on the
    same model.  Every step in ``steps`` lies in the first epoch."""
    was_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _first_steps(coo, item_features, D, W, K, lr, item_alpha, user_alpha,
                            batch_size, model_seed, epochs, steps, device, rounding,
                            fits_before)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was_tf32


def _first_steps(coo, item_features, D, W, K, lr, item_alpha, user_alpha, batch_size,
                 model_seed, epochs, steps, device, rounding, fits_before):
    n_users, n_items = coo.shape
    feats = Features(item_features, device)
    tab, seeds = init_tables(model_seed, feats.n_features, n_users, D, W, epochs, device,
                             fits_before)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    tab["item_log_scale"], tab["user_log_scale"] = zero, zero.clone()
    ex = Examples(coo, batch_size)
    n_batches = ex.n_pad // batch_size
    last = max(steps)
    if last > n_batches:
        raise ValueError(f"step {last} is past the first epoch's {n_batches} steps")
    gen = torch.Generator(device=device).manual_seed(int(seeds[0]))
    perm = torch.randint(0, 1 << 32, (ex.n_pad,), generator=gen, device=device,
                         dtype=torch.int64)
    negs = torch.randint(0, n_items, (n_batches, K, batch_size), generator=gen, device=device)
    order = torch.sort(perm, stable=True).indices.cpu().numpy()
    pos_keys = torch.unique(torch.as_tensor(coo.row.astype(np.int64) * n_items + coo.col,
                                            device=device))

    def put(a, b):
        return torch.as_tensor(a[order[b * batch_size:(b + 1) * batch_size]], device=device)

    out = {}
    for b in range(last + 1):
        if b in steps:
            out[b] = {k: v.to("cpu", copy=True) for k, v in tab.items()}
        if b == last:
            break
        warp_step(tab, feats, put(ex.user, b), put(ex.item, b), put(ex.y, b), put(ex.w, b),
                  put(ex.valid, b), negs[b], pos_keys, n_items, D, lr, item_alpha, user_alpha,
                  rounding)
    return out


def log_scale_gap(prog: dict, ref: dict) -> float:
    """``max over steps after 0 and both sides of |prog - ref| / |ref|`` of
    the log scales (a side whose reference scale is 0 compares as ``|prog|
    / 1e-12``)."""
    return max(abs(float(prog[s][k]) - float(ref[s][k])) / max(abs(float(ref[s][k])), 1e-12)
               for s in ref if s for k in ("item_log_scale", "user_log_scale"))


def fold(state: dict, device, rounding: str = "fp32") -> dict:
    """The end-of-epoch fold of ``state`` (its :data:`FOLD_FIELDS`): each
    table times ``exp(-log_scale)``, computed on ``device`` with the result
    rounded to ``rounding``, and both scales reset to 0.  On the CPU."""
    out = {}
    for side in ("item", "user"):
        table = state[f"{side}_table"].to(device)
        log_scale = state[f"{side}_log_scale"].to(device)
        out[f"{side}_table"] = round_operand(table * torch.exp(-log_scale), rounding).cpu()
        out[f"{side}_log_scale"] = torch.zeros_like(log_scale).cpu()
    return out


def fold_gap(prog: dict, ref: dict) -> float:
    """``max over both sides of ||prog table - ref table|| / ||ref table||``
    and of ``|prog log scale - ref log scale|`` (the reference's is 0)."""
    gaps = []
    for side in ("item", "user"):
        want = ref[f"{side}_table"].double()
        diff = torch.linalg.vector_norm(prog[f"{side}_table"].double() - want)
        gaps.append(float(diff / torch.linalg.vector_norm(want)))
        gaps.append(abs(float(prog[f"{side}_log_scale"]) - float(ref[f"{side}_log_scale"])))
    return max(gaps)
