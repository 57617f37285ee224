"""Plain top-k recommendation over the whole catalog, in PyTorch: the
reference that a recommend cell's results are held against.

A LightFM recommendation is the catalog ranked by the model's score of
each item for the user (``LightFM.predict`` over every item),
``dot(user_emb, item_emb) + user_bias + item_bias``, the user's train
positives left out and the ``k`` best kept.  The reference scores in float64.  Any
float32 evaluation of a score with ``n`` terms lies within ``gamma_n sum
|terms|`` of the exact one (``gamma_n = n u / (1 - n u)``, ``u = 2^-24``);
a score here has ``D + 2`` terms (``D`` products and the two biases).  So
an item that some float32 evaluation may put in a user's top ``k`` scores,
in float64, at least the user's ``k``-th float64 score less its own band
and the widest band among the float64 top ``k``.  A returned item below
that, a train positive or a repeat in one user's list is wrong whatever
the summation order.

Precision: float64 with TF32 off.  :func:`top_k_tf32` is the control: the
top ``k`` over float32 scores of operands rounded to TF32, as a TF32 matrix
product computes them.

Imports neither JAX nor either package of the repository.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.ranks import _gamma, _train_positions, round_tf32


def _blocks(user_table, item_table, users: np.ndarray, train_csr, block: int, device):
    """Yield ``(rows, S, A)`` per block of ``users``: the block's rows in
    ``users``, float64 scores and sums of absolute terms ``[b, n_items]``
    with the train positives at ``-inf``."""
    n_items = train_csr.shape[1]
    it = item_table[:n_items].to(device, torch.float64)
    i_emb, i_bias = it[:, :-1], it[:, -1]
    for start in range(0, len(users), block):
        ub = users[start:start + block]
        ut = user_table[torch.as_tensor(ub, device=user_table.device)].to(device, torch.float64)
        u_emb, u_bias = ut[:, :-1], ut[:, -1:]
        S = u_emb @ i_emb.T + u_bias + i_bias[None, :]
        A = u_emb.abs() @ i_emb.abs().T + u_bias.abs() + i_bias.abs()[None, :]
        S[_train_positions(train_csr, ub, device)] = -np.inf
        yield slice(start, start + len(ub)), S, A


def check(user_table, item_table, train_csr, users, scores, ids, D: int, block: int = 512,
          device=None) -> dict:
    """The numbers a recommend cell compares, of the returned ``scores`` and
    ``ids`` (``[len(users), k]`` numpy arrays) of ``users``:
    ``topk_outside_band``, the returned pairs that are train positives or
    repeats in their list, or whose float64 score lies below the user's
    ``k``-th float64 score by more than the float32 band; and
    ``topk_score_gap``, the largest ``|returned - float64| / |float64|`` of
    a returned score.  Tables are ``[n, W]`` float32 with the bias in the
    last column."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _check(user_table, item_table, train_csr, users, scores, ids, D, block,
                      device or user_table.device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def _check(user_table, item_table, train_csr, users, scores, ids, D, block, device):
    train_csr = train_csr.tocsr()
    k = ids.shape[1]
    gamma = _gamma(D + 2)
    outside, gap = 0, 0.0
    for rows, S, A in _blocks(user_table, item_table, np.asarray(users), train_csr, block,
                              device):
        got = torch.as_tensor(ids[rows].astype(np.int64), device=device)
        got_s = torch.as_tensor(scores[rows], device=device).double()
        top_s, top_i = torch.topk(S, k, dim=1)
        floor = top_s[:, -1:] - gamma * (A.gather(1, got) + A.gather(1, top_i).max(1, True).values)
        s64 = S.gather(1, got)
        srt = torch.sort(got, dim=1).values
        repeat = torch.zeros_like(got, dtype=torch.bool)
        repeat[:, 1:] = srt[:, 1:] == srt[:, :-1]
        bad = ~torch.isfinite(s64) | (s64 < floor) | repeat
        outside += int(bad.sum())
        ok = torch.isfinite(s64) & torch.isfinite(got_s) & (s64 != 0)
        if ok.any():
            gap = max(gap, float(((got_s - s64).abs() / s64.abs())[ok].max()))
    return {"topk_outside_band": outside, "topk_score_gap": gap}


def top_k_tf32(user_table, item_table, train_csr, users, k: int, block: int = 512,
               device=None):
    """The control: ``(scores, ids)`` of the top ``k`` over float32 scores
    whose operands are rounded to TF32, train positives left out."""
    device = device or user_table.device
    train_csr = train_csr.tocsr()
    n_items = train_csr.shape[1]
    it = item_table[:n_items].to(device)
    i_aug = round_tf32(torch.cat([it, torch.ones_like(it[:, :1])], dim=1))
    users = np.asarray(users)
    out_s, out_i = [], []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for start in range(0, len(users), block):
            ub = users[start:start + block]
            ut = user_table[torch.as_tensor(ub, device=user_table.device)].to(device)
            u_aug = round_tf32(torch.cat([ut[:, :-1], torch.ones_like(ut[:, :1]), ut[:, -1:]], 1))
            S = u_aug @ i_aug.T
            S[_train_positions(train_csr, ub, device)] = -np.inf
            s, i = torch.topk(S, k, dim=1)
            out_s.append(s.cpu().numpy())
            out_i.append(i.cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return np.concatenate(out_s), np.concatenate(out_i).astype(np.int32)
