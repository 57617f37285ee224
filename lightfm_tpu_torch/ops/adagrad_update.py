"""Adagrad table update over sorted touches: the Hopper kernel and its plain version.

Counterpart of ``lightfm_tpu/ops/pallas_update.py:234``
(``sorted_adagrad_update_pallas``, K1) and ``:139`` (``adagrad_update_pallas``,
K4 = argsort + K1).  The kernel lives in ``csrc/adagrad_update.cu`` (see its
note for the design and bound); it is built at first use by
:mod:`lightfm_tpu_torch.ops._build` and called through ctypes on PyTorch's
current stream.

Both entry points UPDATE ``table`` AND ``acc`` IN PLACE and return them.
For every touched row r: ``table[r] -= lr * rsqrt(acc_pre[r]) * sum(wg)``
and ``acc[r] += sum(wg * wg)``, duplicates summed, ``acc_pre`` read before
the call, rows outside ``[0, R)`` ignored.  ``precision="default"`` rounds
each ``wg`` and ``wg * wg`` to bf16 (nearest even) before the fp32 sum, as
the TPU kernel's DEFAULT-precision matmul does; ``"highest"`` sums fp32.

Each wrapper takes its plain version only for tensors on the CPU.  A CUDA
tensor launches the kernel or raises; there is no fallback.  ``launches``
counts kernel launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes

import torch

from lightfm_tpu_torch import observability
from lightfm_tpu_torch.ops import _build
from lightfm_tpu_torch.ops.representation import round_to_bf16

PRECISIONS = ("highest", "default")
# Touch positions of one pass-A segment (kSeg in the source; the launcher
# refuses a scratch sized for another).
SEGMENT = 64

launches = {"sorted_adagrad_update": 0, "adagrad_update": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def scratch_shape(M: int, W: int) -> tuple[int, int, int]:
    """The scratch one K1 call over ``M`` sorted touches of a ``W``-wide
    table writes and reads: fp32 [segments, 2, 2W], one (sum wg | sum wg^2)
    row for the run that enters each SEGMENT-touch segment from the one
    before and one for the run that leaves it into the next."""
    if M < 1 or W < 1:
        raise ValueError(f"a K1 launch needs M >= 1 and W >= 1, got M={M}, W={W}")
    return (-(-M // SEGMENT), 2, 2 * W)


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` if its data starts on a 16-byte boundary (the kernel stages
    gradient rows with 16-byte copies), else a fresh copy, which does."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _lib() -> ctypes.CDLL:
    lib = _build.load("adagrad_update")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        lib.sorted_adagrad_update_launch.argtypes = [
            p, p, p, p, p, ll, i, i, ctypes.c_float, i, ll, p,
        ]
        lib.sorted_adagrad_update_launch.restype = i
        lib.adagrad_update_error_string.argtypes = [i]
        lib.adagrad_update_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_args(table, acc, idx, wg, precision) -> None:
    dev = table.device
    for name, x, dtype, ndim in (
        ("table", table, torch.float32, 2),
        ("acc", acc, torch.float32, 2),
        ("idx", idx, torch.int32, 1),
        ("wg", wg, torch.float32, 2),
    ):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if dev.type == "cuda" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if acc.shape != table.shape:
        raise ValueError(f"acc {tuple(acc.shape)} must match table {tuple(table.shape)}")
    if wg.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(
            f"wg must be [M, W] = [{idx.shape[0]}, {table.shape[1]}], got {tuple(wg.shape)}"
        )
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the adagrad update runs on CUDA or CPU tensors, not {dev}")


def sorted_adagrad_update_plain(
    table, acc, idx, wg, learning_rate: float, precision: str = "highest"
):
    """Plain version of both K1 and K4 (the touch order does not matter to
    it): gather the pre-call ``acc``, then ``index_add_`` of
    ``-lr * rsqrt(acc_pre) * wg`` into ``table`` and of ``wg * wg`` into
    ``acc``, in place."""
    keep = (idx >= 0) & (idx < table.shape[0])
    rows = idx[keep].long()
    g = wg[keep]
    g2 = g * g
    if precision == "default":
        g, g2 = round_to_bf16(g), round_to_bf16(g2)
    lrl = learning_rate * torch.rsqrt(acc[rows])
    table.index_add_(0, rows, -(lrl * g))
    acc.index_add_(0, rows, g2)
    return table, acc


@observability.spanned("kernel.k1")
def sorted_adagrad_update(
    table: torch.Tensor,
    acc: torch.Tensor,
    sidx: torch.Tensor,
    swg: torch.Tensor,
    learning_rate: float,
    precision: str = "highest",
):
    """K1: in-place adagrad update over touches whose rows ``sidx`` (int32
    [M]) are NON-DECREASING, with gradients ``swg`` f32 [M, W] in the same
    order.  The kernel relies on the order (a row's touches must form one
    run); it is not checked on the card.  On the card it takes tables whose
    width W is a multiple of 4 (every table the model makes: its width is
    rounded to 8).  One call runs two grids (the segment pass and the
    ordered combine) and counts as one launch."""
    _check_args(table, acc, sidx, swg, precision)
    if table.device.type == "cpu":
        return sorted_adagrad_update_plain(table, acc, sidx, swg, learning_rate, precision)
    R, W = table.shape
    M = sidx.shape[0]
    if M == 0 or R == 0 or W == 0:
        return table, acc
    if W % 4:
        raise ValueError(f"the K1 kernel takes tables whose width is a multiple of 4, got {W}")
    lib = _lib()
    swg = aligned(swg)
    part = torch.empty(scratch_shape(M, W), dtype=torch.float32, device=table.device)
    code = lib.sorted_adagrad_update_launch(
        table.data_ptr(), acc.data_ptr(), sidx.data_ptr(), swg.data_ptr(), part.data_ptr(),
        M, R, W, float(learning_rate), int(precision == "default"), part.shape[0],
        ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream),
    )
    if code:
        msg = lib.adagrad_update_error_string(code).decode()
        raise RuntimeError(f"sorted_adagrad_update kernel launch failed: {msg} (cudaError {code})")
    launches["sorted_adagrad_update"] += 1
    return table, acc


def adagrad_update(
    table: torch.Tensor,
    acc: torch.Tensor,
    idx: torch.Tensor,
    wg: torch.Tensor,
    learning_rate: float,
    precision: str = "highest",
):
    """K4: in-place adagrad update over UNSORTED touches: a stable argsort
    of ``idx``, then :func:`sorted_adagrad_update`."""
    _check_args(table, acc, idx, wg, precision)
    if table.device.type == "cpu":
        return sorted_adagrad_update_plain(table, acc, idx, wg, learning_rate, precision)
    order = torch.argsort(idx, stable=True)
    out = sorted_adagrad_update(
        table, acc, idx[order], wg[order], learning_rate, precision
    )
    launches["adagrad_update"] += 1
    return out
