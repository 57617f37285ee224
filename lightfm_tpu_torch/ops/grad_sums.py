"""Per-row gradient sums over sorted touches: the Hopper kernel and its plain version.

Counterpart of ``lightfm_tpu/ops/pallas_update.py:365``
(``sorted_grad_sums_pallas``, K3).  The kernel lives in ``csrc/grad_sums.cu``
(see its note for the design and bound); it is built at first use by
:mod:`lightfm_tpu_torch.ops._build` and called through ctypes on PyTorch's
current stream.

``sorted_grad_sums(sidx, swg, n_rows)`` returns a new f32 ``[n_rows, 2W]``
tensor: ``[:, :W] = sum(wg)`` and ``[:, W:] = sum(wg * wg)`` over each row's
touches, duplicates summed, rows outside ``[0, n_rows)`` ignored, untouched
rows exactly 0.  ``precision="default"`` rounds each ``wg`` and ``wg * wg``
to bf16 (nearest even) before the fp32 sum, as the TPU kernel's
DEFAULT-precision matmul does; ``"highest"`` sums fp32.  It feeds the hybrid
training path's aggregated feature update
(:func:`lightfm_tpu_torch.fast_warp._aggregated_feature_update`).

The wrapper takes its plain version only for tensors on the CPU.  A CUDA
tensor launches the kernel or raises; there is no fallback.  ``launches``
counts kernel launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes

import torch

from lightfm_tpu_torch.ops import _build
from lightfm_tpu_torch.ops.representation import round_to_bf16

PRECISIONS = ("highest", "default")

launches = {"sorted_grad_sums": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("grad_sums")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sorted_grad_sums_launch.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, p]
        lib.sorted_grad_sums_launch.restype = i
        lib.grad_sums_error_string.argtypes = [i]
        lib.grad_sums_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_args(sidx, swg, n_rows, precision) -> None:
    for name, x, dtype, ndim in (("sidx", sidx, torch.int32, 1), ("swg", swg, torch.float32, 2)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(x.shape)}")
        if x.device.type == "cuda" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if swg.device != sidx.device:
        raise ValueError(f"swg is on {swg.device}, expected {sidx.device}")
    if swg.shape[0] != sidx.shape[0]:
        raise ValueError(f"swg has {swg.shape[0]} rows for {sidx.shape[0]} touches")
    if int(n_rows) < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if sidx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the gradient sums run on CUDA or CPU tensors, not {sidx.device}")


def sorted_grad_sums_plain(sidx, swg, n_rows: int, precision: str = "highest"):
    """Plain version (the touch order does not matter to it): one
    ``index_add_`` of ``[wg | wg * wg]`` into zeros, with the same rounding."""
    keep = (sidx >= 0) & (sidx < n_rows)
    g = swg[keep]
    g2 = g * g
    if precision == "default":
        g, g2 = round_to_bf16(g), round_to_bf16(g2)
    out = torch.zeros((int(n_rows), 2 * swg.shape[1]), dtype=torch.float32, device=swg.device)
    out.index_add_(0, sidx[keep].long(), torch.cat([g, g2], dim=1))
    return out


def sorted_grad_sums(sidx: torch.Tensor, swg: torch.Tensor, n_rows: int,
                     precision: str = "highest") -> torch.Tensor:
    """K3: ``[n_rows, 2W]`` per-row ``[sum(wg) | sum(wg^2)]`` over touches
    whose rows ``sidx`` (int32 [M]) are NON-DECREASING, with gradients
    ``swg`` f32 [M, W] in the same order.  The kernel relies on the order (a
    row's touches must form one run); it is not checked on the card."""
    _check_args(sidx, swg, n_rows, precision)
    if sidx.device.type == "cpu":
        return sorted_grad_sums_plain(sidx, swg, n_rows, precision)
    R, W = int(n_rows), swg.shape[1]
    out = torch.empty((R, 2 * W), dtype=torch.float32, device=swg.device)
    if R == 0 or W == 0:
        return out
    lib = _lib()
    code = lib.sorted_grad_sums_launch(
        out.data_ptr(), sidx.data_ptr(), swg.data_ptr(), sidx.shape[0], R, W,
        int(precision == "default"),
        ctypes.c_void_p(torch.cuda.current_stream(swg.device).cuda_stream),
    )
    if code:
        msg = lib.grad_sums_error_string(code).decode()
        raise RuntimeError(f"sorted_grad_sums kernel launch failed: {msg} (cudaError {code})")
    launches["sorted_grad_sums"] += 1
    return out
