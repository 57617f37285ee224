"""Plain WARP training with adagrad, on the sampling of the port's fast
path, in plain PyTorch: the reference that a fit cell's first steps are
held against.

LightFM's WARP step (``_lightfm_fast.pyx.template:784-912``) as the fast
path samples it: every epoch assigns examples to batches by a keyed
four-round Feistel bijection and sorts each batch by item; every step
draws one pool of ``P`` item ids and ``K`` rotations, so candidate ``k``
of the example in batch slot ``b`` is pool slot ``(b mod P + shift_k) mod
P``.  An example takes the first candidate that violates the margin
(score above the positive's minus 1) and is not one of the user's
positives, with rank weight ``log(max(floor((n_items - 1) / (j + 1)),
1))`` and the loss clipped at 10.  Updates, in order within a step: the
positives' rows (pre-step accumulator), the pool rows (the accumulator the
positives left), the users' rows (pre-step accumulator); duplicates sum.
Users and items are identity features: one table row each.

Precision: the configuration's ``"default"`` rounds the operands of the
candidate scores, of the pool-slot gradient sums and of the per-row
gradient sums to bfloat16 and sums in float32; ``rounding``
names that precision (``"bf16"``), or a lower one for the control
(``"fp8"``: float8 e4m3 with a power-of-two scale per operand).  Random
draws (initial tables, batch keys, pools, rotations) are made from the
model's seed as the program's documented draws make them.

Imports neither JAX nor either package of the repository.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_LOSS = 10.0
_MASK32 = np.uint64(0xFFFFFFFF)


def round_operand(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """``x`` rounded, nearest even, to the named precision and back to
    float32: ``"bf16"``, ``"fp8"`` (e4m3, scaled by the power of two that
    brings the tensor's largest magnitude under 448) or ``"fp32"``."""
    if rounding == "fp32":
        return x
    if rounding == "bf16":
        return x.to(torch.bfloat16).float()
    if rounding == "fp8":
        amax = float(x.abs().max()) if x.numel() else 0.0
        if amax == 0.0:
            return x
        scale = 2.0 ** np.floor(np.log2(448.0 / amax))
        return (x * scale).to(torch.float8_e4m3fn).float() / scale
    raise ValueError(f"unknown rounding {rounding!r}")


def init_tables(model_seed: int, n_item_rows: int, n_user_rows: int, D: int, W: int,
                epochs: int, device, fits_before: int = 0):
    """LightFM's initial state (``lightfm/lightfm.py:281-312``) at the start
    of a fit of ``epochs`` epochs made after ``fits_before`` such fits on
    the same model: embeddings ``(U[0, 1) - 0.5) / D`` (items first, drawn
    on ``device`` from a seed that the model's ``RandomState`` gives), zero
    biases and padding columns, accumulators at 1; and the ``epochs`` epoch
    seeds the model draws next.  Every fit draws its state's seed, then its
    epochs' seeds, from the model's ``RandomState``.  Returns ``(tables,
    epoch_seeds)``."""
    rs = np.random.RandomState(model_seed)
    top = np.iinfo(np.int32).max
    for _ in range(fits_before):
        rs.randint(0, top)
        rs.randint(0, top, size=epochs)
    seed = int(rs.randint(0, top))
    gen = torch.Generator(device=device).manual_seed(seed)

    def table(n):
        t = torch.zeros((n, W), dtype=torch.float32, device=device)
        t[:, :D] = (torch.rand((n, D), generator=gen, device=device) - 0.5) / D
        return t

    item = table(n_item_rows)
    user = table(n_user_rows)
    tables = {"item_table": item, "item_acc": torch.ones_like(item),
              "user_table": user, "user_acc": torch.ones_like(user)}
    seeds = rs.randint(0, np.iinfo(np.int32).max, size=epochs).astype(np.uint32)
    return tables, seeds


def _hash_u32(x: np.ndarray, k: np.uint64) -> np.ndarray:
    x = ((x ^ k) * np.uint64(0x85EBCA6B)) & _MASK32
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & _MASK32
    return x ^ (x >> np.uint64(16))


def feistel_batches(n: int, n_batches: int, keys) -> np.ndarray:
    """Batch of each of ``n`` examples: four Feistel rounds on ``(i //
    n_batches, i % n_batches)`` keyed by ``keys`` (four u32 values), each
    round's hash reduced into its radix; every batch gets ``n /
    n_batches`` examples."""
    R, Q = np.uint64(n_batches), np.uint64(n // n_batches)
    k = [np.uint64(int(v)) for v in keys]
    i = np.arange(n, dtype=np.uint64)
    q, r = i // R, i % R
    q = (q + _hash_u32(r, k[0]) % Q) % Q
    r = (r + _hash_u32(q, k[1]) % R) % R
    q = (q + _hash_u32(r, k[2]) % Q) % Q
    r = (r + _hash_u32(q, k[3]) % R) % R
    return r.astype(np.int64)


class Examples:
    """The training examples padded to whole batches: user, item, value,
    weight and a valid flag (padding rows: user 0, item 0, zeros)."""

    def __init__(self, coo, batch_size: int):
        n = coo.nnz
        self.n_pad = max(1, -(-n // batch_size)) * batch_size
        self.batch_size = batch_size
        self.user = np.zeros(self.n_pad, np.int64)
        self.item = np.zeros(self.n_pad, np.int64)
        self.y = np.zeros(self.n_pad, np.float32)
        self.w = np.zeros(self.n_pad, np.float32)
        self.valid = np.zeros(self.n_pad, bool)
        self.user[:n], self.item[:n] = coo.row, coo.col
        self.y[:n], self.w[:n], self.valid[:n] = coo.data, 1.0, True

    def epoch_order(self, keys) -> np.ndarray:
        """Example order of one epoch: by Feistel batch, then by item, ties
        in example order."""
        batch = feistel_batches(self.n_pad, self.n_pad // self.batch_size, keys)
        return np.lexsort((self.item, batch))


def _unit_bias(x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    out[:, -1] = 1.0
    return out


def _adagrad_dense(table, acc, S1, S2, lr: float):
    """``table -= lr rsqrt(acc) S1``, ``acc += S2`` (rows with zero sums
    are unchanged)."""
    table -= lr * torch.rsqrt(acc) * S1
    acc += S2


def _row_sums(n_rows: int, rows, g, rounding: str):
    gr = round_operand(g, rounding)
    g2 = round_operand(g * g, rounding)
    S1 = torch.zeros((n_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    S2 = torch.zeros_like(S1)
    S1.index_add_(0, rows, gr)
    S2.index_add_(0, rows, g2)
    return S1, S2


def warp_step(tab: dict, uid, iid, y, w, valid, pool_ids, shifts, pos_keys, n_items: int,
              lr: float, rounding: str):
    """One WARP step over an item-sorted batch, updating ``tab`` in place.
    ``pos_keys``: sorted ``user * n_items + item`` of the distinct train
    positives."""
    B = uid.shape[0]
    K = shifts.shape[0]
    P = pool_ids.shape[0]
    dev = uid.device
    it, ut = tab["item_table"], tab["user_table"]

    u = ut[uid]
    p = it[iid]
    u1 = _unit_bias(u)
    pos_pred = (u1 * p).sum(-1) + u[:, -1]
    slot = (torch.arange(B, device=dev)[None, :] % P + shifts[:, None]) % P  # [K, B]
    cand = pool_ids[slot]
    cand_reps = round_operand(it[pool_ids], rounding)[slot]  # [K, B, W]
    preds = (round_operand(u1, rounding)[None] * cand_reps).sum(-1) + u[:, -1][None]

    keys = uid[None, :] * n_items + cand
    at = torch.searchsorted(pos_keys, keys).clamp(max=pos_keys.shape[0] - 1)
    is_pos = pos_keys[at] == keys
    ok = (preds > pos_pred[None, :] - 1.0) & ~is_pos
    ks = torch.arange(K, device=dev)[:, None].expand(K, B)
    j = torch.where(ok, ks, torch.full_like(ks, K)).min(0).values
    found = j < K
    j = torch.where(found, j, torch.zeros_like(j))
    rank_weight = torch.log(torch.clamp(torch.floor((n_items - 1) / (j + 1).float()), min=1.0))
    loss = torch.clamp(w * rank_weight, max=MAX_LOSS)
    lossm = torch.where(valid & (y > 0) & found, loss, torch.zeros_like(loss))

    cols = torch.arange(B, device=dev)
    neg = cand_reps[j, cols]
    neg_slot = slot[j, cols]
    gi = lossm[:, None] * u1
    gu = lossm[:, None] * _unit_bias(neg - p)
    W = u.shape[1]
    gp = torch.zeros((P, W), dtype=torch.float32, device=dev)
    gp2 = torch.zeros_like(gp)
    gp.index_add_(0, neg_slot, round_operand(lossm, rounding)[:, None] * round_operand(u1, rounding))
    gp2.index_add_(0, neg_slot, round_operand(lossm * lossm, rounding)[:, None]
                   * round_operand(u1 * u1, rounding))

    _adagrad_dense(it, tab["item_acc"], *_row_sums(it.shape[0], iid, -gi, rounding), lr)
    S1 = torch.zeros_like(it).index_add_(0, pool_ids, gp)
    S2 = torch.zeros_like(it).index_add_(0, pool_ids, gp2)
    _adagrad_dense(it, tab["item_acc"], S1, S2, lr)
    _adagrad_dense(ut, tab["user_acc"], *_row_sums(ut.shape[0], uid, gu, rounding), lr)


def first_steps(coo, *, D: int, W: int, K: int, lr: float, batch_size: int, pool_size: int,
                model_seed: int, epochs: int, steps, device, rounding: str = "bf16",
                fits_before: int = 0) -> dict:
    """The state ``{step: tables on the CPU}`` after each step in ``steps``
    (0 is the initial state) of the first epoch of a fit of ``coo`` made
    after ``fits_before`` fits on the same model."""
    n_users, n_items = coo.shape
    tab, seeds = init_tables(model_seed, n_items, n_users, D, W, epochs, device,
                              fits_before)
    ex = Examples(coo, batch_size)
    n_batches = ex.n_pad // batch_size
    gen = torch.Generator(device=device).manual_seed(int(seeds[0]))
    keys = torch.randint(0, 1 << 32, (4,), generator=gen, device=device, dtype=torch.int64)
    P = min(pool_size, batch_size)
    pools = torch.randint(0, n_items, (n_batches, P), generator=gen, device=device)
    shifts = torch.randint(0, P, (n_batches, K), generator=gen, device=device)
    order = ex.epoch_order(keys.cpu().numpy())
    pos_keys = torch.unique(torch.as_tensor(coo.row.astype(np.int64) * n_items + coo.col,
                                            device=device))

    def put(a, b):
        return torch.as_tensor(a[order[b * batch_size:(b + 1) * batch_size]], device=device)

    out = {}
    last = max(steps)
    for b in range(last + 1):
        if b in steps:
            out[b] = {k: v.to("cpu", copy=True) for k, v in tab.items()}
        if b == last:
            break
        warp_step(tab, put(ex.user, b), put(ex.item, b), put(ex.y, b), put(ex.w, b),
                  put(ex.valid, b), pools[b], shifts[b], pos_keys, n_items, lr, rounding)
    return out
