"""Plain ranking of held-out items, in PyTorch: the reference that an
evaluation cell's ranks are held against.

LightFM's ``predict_rank`` (``lightfm/lightfm.py:884-989``,
``_lightfm_fast.pyx.template:1232-1323``): for every test interaction
``(u, t)``, the number of catalog items ``i != t``, the user's train
positives left out, whose score is ``>=`` the score of ``t``, where a score
is ``dot(user_emb, item_emb) + user_bias + item_bias``.

Any float32 evaluation of a score with ``n`` terms lies within ``gamma_n
sum |terms|`` of the exact one (``gamma_n = n u / (1 - n u)``, ``u =
2^-24``), so the reference scores in float64 and gives every test
interaction a band ``[lo, hi]``: ``lo`` counts the items certainly above
the test item under any such evaluation, ``hi`` those that may be.  A rank
outside its band is wrong whatever the summation order.

Imports neither JAX nor either package of the repository.
"""

from __future__ import annotations

import numpy as np
import torch


def _gamma(n: int) -> float:
    u = 2.0 ** -24
    return n * u / (1.0 - n * u)


def _test_slots(test_csr, users: np.ndarray):
    """``[len(users), T]`` test item ids (-1 padding) and their positions
    in the CSR's data array."""
    lengths = np.diff(test_csr.indptr)[users]
    T = int(lengths.max())
    items = np.full((len(users), T), -1, np.int64)
    where = np.full((len(users), T), -1, np.int64)
    slot = np.arange(int(lengths.sum())) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    row = np.repeat(np.arange(len(users)), lengths)
    flat = np.repeat(test_csr.indptr[users], lengths) + slot
    items[row, slot] = test_csr.indices[flat]
    where[row, slot] = flat
    return items, where


def _train_positions(train_csr, users: np.ndarray, device):
    """``(block row, item)`` index tensors of the users' train positives."""
    lengths = np.diff(train_csr.indptr)[users]
    rows = np.repeat(np.arange(len(users)), lengths)
    sub = train_csr[users]
    return torch.as_tensor(rows, device=device), torch.as_tensor(sub.indices, device=device)


def _blocks(user_table, item_table, test_csr, train_csr, block: int, device):
    """Yield ``(S, A, keep, items, where)`` per block of test users: float64
    scores and sums of absolute terms ``[b, n_items]``, the mask of items
    that count (train positives out), and the block's test slots."""
    n_items = test_csr.shape[1]
    it = item_table[:n_items].to(device, torch.float64)
    i_emb, i_bias = it[:, :-1], it[:, -1]
    users = np.flatnonzero(np.diff(test_csr.indptr) > 0)
    train_csr = train_csr.tocsr()
    for start in range(0, len(users), block):
        ub = users[start:start + block]
        ut = user_table[torch.as_tensor(ub, device=user_table.device)].to(device, torch.float64)
        u_emb, u_bias = ut[:, :-1], ut[:, -1:]
        S = u_emb @ i_emb.T + u_bias + i_bias[None, :]
        A = u_emb.abs() @ i_emb.abs().T + u_bias.abs() + i_bias.abs()[None, :]
        keep = torch.ones(S.shape, dtype=torch.bool, device=device)
        keep[_train_positions(train_csr, ub, device)] = False
        items, where = _test_slots(test_csr, ub)
        yield S, A, keep, items, where


def rank_bands(user_table, item_table, test_csr, train_csr, block: int = 512, device=None):
    """``(lo, hi)``, float64 arrays aligned with ``test_csr``'s data: the
    ranks that some float32 evaluation of the scores could give.  Tables
    are ``[n, W]`` float32 with the bias in the last column."""
    device = device or user_table.device
    W = user_table.shape[1]
    gamma = _gamma(W + 1)  # W - 1 embedding products and two biases
    lo = np.zeros(test_csr.nnz)
    hi = np.zeros(test_csr.nnz)
    for S, A, keep, items, where in _blocks(user_table, item_table, test_csr, train_csr,
                                            block, device):
        rows = torch.arange(S.shape[0], device=device)
        for t in range(items.shape[1]):
            valid = items[:, t] >= 0
            ti = torch.as_tensor(np.where(valid, items[:, t], 0), device=device)
            st, at = S[rows, ti][:, None], A[rows, ti][:, None]
            diff = S - st
            tol = gamma * (A + at)
            n_lo = ((diff > tol) & keep).sum(1).cpu().numpy()
            n_hi = ((diff >= -tol) & keep).sum(1).cpu().numpy() - 1  # the test item itself
            lo[where[valid, t]] = n_lo[valid]
            hi[where[valid, t]] = n_hi[valid]
    return lo, hi


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded, nearest even, to TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def ranks_tf32(user_table, item_table, test_csr, train_csr, block: int = 512, device=None):
    """The control: ranks counted over float32 scores whose operands are
    rounded to TF32, as a TF32 matrix product computes them."""
    device = device or user_table.device
    n_items = test_csr.shape[1]
    it = item_table[:n_items].to(device)
    i_aug = round_tf32(torch.cat([it, torch.ones_like(it[:, :1])], dim=1))
    users = np.flatnonzero(np.diff(test_csr.indptr) > 0)
    train_csr = train_csr.tocsr()
    out = np.zeros(test_csr.nnz)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for start in range(0, len(users), block):
            ub = users[start:start + block]
            ut = user_table[torch.as_tensor(ub, device=user_table.device)].to(device)
            u_aug = round_tf32(torch.cat([ut[:, :-1], torch.ones_like(ut[:, :1]), ut[:, -1:]], 1))
            S = u_aug @ i_aug.T
            S[_train_positions(train_csr, ub, device)] = -np.inf
            items, where = _test_slots(test_csr, ub)
            r = torch.arange(S.shape[0], device=device)
            for t in range(items.shape[1]):
                valid = items[:, t] >= 0
                ti = torch.as_tensor(np.where(valid, items[:, t], 0), device=device)
                n = (S >= S[r, ti][:, None]).sum(1).cpu().numpy() - 1
                out[where[valid, t]] = n[valid]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def outside_band(ranks: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> int:
    """How many ranks lie outside their band."""
    return int(((ranks < lo) | (ranks > hi)).sum())
