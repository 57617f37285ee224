"""Whole-fit WARP + adagrad in one launch: the Hopper kernel and its plain version.

Counterpart of ``lightfm_tpu/ops/pallas_train.py:174`` (``warp_fit_fused``,
K5): an entry point of its own, for small models with identity features and
no L2, that runs every step of a multi-epoch WARP fit inside one kernel
launch.  The caller makes the steps' inputs: pre-shuffled packed batches,
every step's negative candidates (slot-major) and the per-user positives.
The kernel lives in ``csrc/warp_fit.cu`` (see its note for the design and
bound); it is built at first use by :mod:`lightfm_tpu_torch.ops._build` and
called through ctypes on PyTorch's current stream.  It is ONE cooperative
launch (``cudaLaunchCooperativeKernel``) of ``blocks`` blocks of 512
threads, one block an SM by default: each step is a forward across the whole
grid (a warp per example) and an apply in which block r updates the rows
with ``row % blocks == r``, each closed by a grid-wide barrier.  A
cooperative grid must be resident all at once, so a grid larger than the
card holds (the occupancy API's blocks per SM x SMs) is refused and raises.
Every row's sums are taken in the same order at any grid size: the result
does not depend on ``blocks``.

Semantics per step (``_train_kernel``, ``pallas_train.py:84-167``): the
selected negative of example b is the first candidate k, in order, whose
score beats the positive's score minus 1 and that is not in the user's
positives row; rank weight ``log(max(1, floor((n_items-1)/(k+1))))``, loss
clipped at ``MAX_LOSS``; an update only where ``valid & (y > 0) & found``;
items get ``-L*u1`` at the positive and ``+L*u1`` at the negative, users
``L*[n_rep - p_rep | 1]``; adagrad with the PRE-step accumulator for both
tables.  Gathers are exact fp32 reads: the TPU kernel's one-hot matmuls in
interpret mode (on the TPU itself they would round table values to bf16).

Both entry points return new tensors and leave their inputs alone.  The
wrapper takes its plain version only for tensors on the CPU.  A CUDA tensor
launches the kernel or raises; there is no fallback.  ``launches`` counts
kernel launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes

import torch

from lightfm_tpu_torch import observability
from lightfm_tpu_torch.config import MAX_LOSS
from lightfm_tpu_torch.ops import _build

launches = {"warp_fit_fused": 0}

MAX_WIDTH = 128  # table width the kernel holds in registers (4 columns a lane)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("warp_fit")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.warp_fit_launch.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, i, i, f, f, p, p, p, p, i, i, p,
        ]
        lib.warp_fit_launch.restype = i
        lib.warp_fit_smem_key_capacity.argtypes = []
        lib.warp_fit_smem_key_capacity.restype = i
        lib.warp_fit_sync_probe.argtypes = [i, i, p]
        lib.warp_fit_sync_probe.restype = i
        lib.warp_fit_chase_probe.argtypes = [p, i, p, p]
        lib.warp_fit_chase_probe.restype = i
        lib.warp_fit_error_string.argtypes = [i]
        lib.warp_fit_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_args(user_table, user_acc, item_table, item_acc, batches, negatives,
                positives, max_sampled) -> None:
    dev = user_table.device
    for name, x, dtype, ndim in (
        ("user_table", user_table, torch.float32, 2),
        ("user_acc", user_acc, torch.float32, 2),
        ("item_table", item_table, torch.float32, 2),
        ("item_acc", item_acc, torch.float32, 2),
        ("batches", batches, torch.int32, 3),
        ("negatives", negatives, torch.int32, 3),
        ("positives", positives, torch.int32, 2),
    ):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
    U, W = user_table.shape
    I = item_table.shape[0]
    if user_acc.shape != (U, W) or item_acc.shape != (I, W) or item_table.shape[1] != W:
        raise ValueError("tables and accumulators must share the width W and their row counts")
    S, rows, B = batches.shape
    if rows != 8:
        raise ValueError(f"batches must be [S, 8, B], got {tuple(batches.shape)}")
    if negatives.shape != (S, 1, max_sampled * B):
        raise ValueError(
            f"negatives must be [S, 1, K*B] = [{S}, 1, {max_sampled * B}], "
            f"got {tuple(negatives.shape)}"
        )
    if positives.shape[0] != U:
        raise ValueError(f"positives must have one row per user ({U}), got {positives.shape[0]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the fit runs on CUDA or CPU tensors, not {dev}")
    if dev.type == "cuda":
        if W > MAX_WIDTH:
            raise ValueError(f"the kernel takes tables up to {MAX_WIDTH} wide, got {W}")
        # Out-of-range ids would read outside the tables on the card.
        if S and B and (
            int(batches[:, 0].min()) < 0 or int(batches[:, 0].max()) >= U
            or int(batches[:, 1].min()) < 0 or int(batches[:, 1].max()) >= I
            or int(negatives.min()) < 0 or int(negatives.max()) >= I
        ):
            raise ValueError("user, item and negative ids must lie inside the tables")


def warp_fit_fused_plain(user_table, user_acc, item_table, item_acc, batches, negatives,
                         positives, *, n_items: int, max_sampled: int,
                         learning_rate: float):
    """Plain version: a per-step loop of torch operations with the kernel's
    semantics.  Returns the new ``(user_table, user_acc, item_table,
    item_acc)``."""
    ut, ua, it, ia = (x.clone() for x in (user_table, user_acc, item_table, item_acc))
    S, _, B = batches.shape
    K, W = max_sampled, ut.shape[1]
    bias = torch.arange(W, device=ut.device) == W - 1
    one = torch.ones((), device=ut.device)
    for s in range(S):
        bt = batches[s]
        uid, iid = bt[0].long(), bt[1].long()
        y, wt, valid = bt[2].view(torch.float32), bt[3].view(torch.float32), bt[4] > 0
        u_rep, p_rep = ut[uid], it[iid]
        u1 = torch.where(bias, one, u_rep)
        u_bias = u_rep[:, W - 1]
        pos_pred = (u1 * p_rep).sum(1) + u_bias
        negs = negatives[s, 0].reshape(K, B).long()  # slot-major: [k, b]
        npred = (u1[None] * it[negs]).sum(2) + u_bias  # [K, B]
        is_pos = (positives[uid][None, :, :] == negs[:, :, None]).any(2)
        hit = (npred > pos_pred - 1.0) & ~is_pos
        found = hit.any(0)
        j = torch.argmax(hit.to(torch.uint8), 0)  # the first hit
        neg = negs.gather(0, j[None])[0]
        sampled = (j + 1).to(torch.float32)
        rank_w = torch.log(torch.clamp(torch.floor((n_items - 1) / sampled), min=1.0))
        loss = torch.clamp(wt * rank_w, max=MAX_LOSS)
        L = torch.where(valid & (y > 0) & found, loss, torch.zeros_like(loss))
        lu = L[:, None] * u1
        gu = L[:, None] * torch.where(bias, one, it[neg] - p_rep)
        s_item = torch.zeros_like(it).index_add_(0, iid, -lu).index_add_(0, neg, lu)
        s_item2 = torch.zeros_like(it).index_add_(0, iid, lu * lu).index_add_(0, neg, lu * lu)
        s_user = torch.zeros_like(ut).index_add_(0, uid, gu)
        s_user2 = torch.zeros_like(ut).index_add_(0, uid, gu * gu)
        it.sub_(learning_rate * torch.rsqrt(ia) * s_item)  # pre-step accumulators
        ia.add_(s_item2)
        ut.sub_(learning_rate * torch.rsqrt(ua) * s_user)
        ua.add_(s_user2)
    return ut, ua, it, ia


@observability.spanned("kernel.k5")
def warp_fit_fused(user_table: torch.Tensor, user_acc: torch.Tensor,
                   item_table: torch.Tensor, item_acc: torch.Tensor,
                   batches: torch.Tensor, negatives: torch.Tensor,
                   positives: torch.Tensor, *, n_items: int, max_sampled: int,
                   learning_rate: float, blocks: int | None = None):
    """K5: the whole WARP fit over ``batches`` (int32 [S, 8, B], the packed
    layout of ``train.TrainData``), ``negatives`` (int32 [S, 1, K*B],
    candidate k of example b at ``k*B + b``) and ``positives`` (int32
    [U, P], each user's positive item ids padded with an id no candidate
    has), in ONE kernel launch.  ``blocks`` sizes the cooperative grid on
    the card (default: one block an SM); the plain version has none.
    Returns the new ``(user_table, user_acc, item_table, item_acc)``."""
    _check_args(user_table, user_acc, item_table, item_acc, batches, negatives,
                positives, max_sampled)
    if user_table.device.type == "cpu":
        return warp_fit_fused_plain(
            user_table, user_acc, item_table, item_acc, batches, negatives, positives,
            n_items=n_items, max_sampled=max_sampled, learning_rate=learning_rate,
        )
    out = tuple(x.clone().contiguous() for x in (user_table, user_acc, item_table, item_acc))
    S, _, B = batches.shape
    W = user_table.shape[1]
    if S == 0 or B == 0:
        return out
    batches, negatives, positives = (x.contiguous() for x in (batches, negatives, positives))
    dev = user_table.device
    if blocks is None:  # one block an SM
        blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _lib()
    cap = 3 * B  # a block's key list holds every touch of a step
    lu = torch.empty((B, W), dtype=torch.float32, device=dev)
    gu = torch.empty((B, W), dtype=torch.float32, device=dev)
    touch = torch.empty((cap,), dtype=torch.int32, device=dev)
    in_smem = cap <= lib.warp_fit_smem_key_capacity()
    keys = torch.empty((1 if in_smem else blocks * 2 * cap,), dtype=torch.int64, device=dev)
    code = lib.warp_fit_launch(
        *(x.data_ptr() for x in out), batches.data_ptr(), negatives.data_ptr(),
        positives.data_ptr(), S, B, max_sampled, W, positives.shape[1], int(n_items),
        float(learning_rate), float(MAX_LOSS), lu.data_ptr(), gu.data_ptr(),
        touch.data_ptr(), keys.data_ptr(), cap, int(blocks),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if code:
        msg = lib.warp_fit_error_string(code).decode()
        raise RuntimeError(f"warp_fit_fused kernel launch failed: {msg} (cudaError {code})")
    launches["warp_fit_fused"] += 1
    return out
