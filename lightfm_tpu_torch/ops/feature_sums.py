"""Feature sums and candidate scores: the Hopper kernel and its plain version.

Replaces no Pallas kernel: ``lightfm_tpu/ops/representation.py:22``
(``batch_representation``) leaves the feature sums to XLA's gather and sum.
The kernel lives in ``csrc/feature_sums.cu`` (see its note for why it was
added, its bound and its design); it is built at first use by
:mod:`lightfm_tpu_torch.ops._build` and called through ctypes on PyTorch's
current stream.

``feature_sums(table, idx, wts, ids, scale=None, users=None)`` returns
``(reps, scores)``: ``reps[n] = sum_p fl(wts[ids[n], p] * scale) *
table[idx[ids[n], p]]``, f32 ``[N, W]``, for padded feature rows ``idx``,
``wts`` ``[R, P]`` (padding slots of weight 0); and with ``users`` ``[B,
W]`` (``N = C * B``, candidate ``n`` of batch row ``n % B``, slot-major)
``scores`` ``[C, B]``, each candidate's dot with its user's row whose bias
slot counts as 1, plus the user's bias (:func:`~lightfm_tpu_torch.ops.
representation.score_candidates`), else None.  ``scale`` is None (exactly
1), a Python number, or a 0-dim f32 tensor on the table's device, which the
kernel reads itself (no host sync).  The kernel sums in slot order with
fp32 fused multiply-adds; the plain version is the PyTorch composition it
replaced, so kernel and plain agree to rounding.

The wrapper takes its plain version only for tensors on the CPU.  A CUDA
tensor launches the kernel or raises; there is no fallback.  ``launches``
counts kernel launches (never plain-version calls), and each launch adds its
rows ``N`` to the counter ``feature_sum_rows``.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from lightfm_tpu_torch import observability
from lightfm_tpu_torch.ops import _build

launches = {"feature_sums": 0}
_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("feature_sums")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.feature_sums_launch.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_float,
                                            ctypes.c_longlong, i, i, i, i, i, p]
        lib.feature_sums_launch.restype = i
        lib.feature_sums_error_string.argtypes = [i]
        lib.feature_sums_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_args(table, idx, wts, ids, scale, users) -> None:
    named = [("table", table, torch.float32, 2), ("idx", idx, torch.int32, 2),
             ("wts", wts, torch.float32, 2), ("ids", ids, torch.int32, 1)]
    if users is not None:
        named.append(("users", users, torch.float32, 2))
    if isinstance(scale, torch.Tensor):
        named.append(("scale", scale, torch.float32, 0))
    elif scale is not None and not isinstance(scale, numbers.Real):
        raise TypeError(f"scale must be None, a number or a 0-dim tensor, got {type(scale)}")
    for name, x, dtype, ndim in named:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(x.shape)}")
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, expected {table.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the feature sums run on CUDA or CPU tensors, not {table.device}")
    if idx.shape != wts.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and wts {tuple(wts.shape)} differ in shape")
    if max(*table.shape, *idx.shape) > _INT32_MAX:
        raise ValueError("table and feature rows must have fewer than 2**31 rows and columns")
    if users is not None:
        if users.shape[1] != table.shape[1]:
            raise ValueError(f"users are {users.shape[1]} wide, the table {table.shape[1]}")
        B, N = users.shape[0], ids.shape[0]
        if (N % B if B else N) or (B and N // B > _INT32_MAX):
            raise ValueError(f"{N} candidates are not a whole number of rows of {B} users")


def feature_sums_plain(table, idx, wts, ids, scale=None, users=None):
    """Plain version: the padded rows' feature sums as a batched IEEE fp32
    GEMV over the gathered ``[N, P, W]`` table rows
    (``representation._weighted_sum``) and the scores as
    ``representation.score_candidates``."""
    # Imported here: representation's padded reads call this module.
    from lightfm_tpu_torch.ops.representation import _weighted_sum, score_candidates

    rows = ids.long()
    w = wts[rows]
    if scale is not None:
        w = w * scale
    reps = _weighted_sum(w, table[idx[rows].long()])
    if users is None:
        return reps, None
    B = users.shape[0]
    return reps, score_candidates(users, reps, ids.shape[0] // B if B else 0)


@observability.spanned("kernel.feature_sums")
def feature_sums(table: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, ids: torch.Tensor,
                 scale=None, users: torch.Tensor | None = None):
    """``(reps [N, W], scores [C, B] or None)`` of the padded feature rows
    ``ids`` (int32 [N]) of ``idx``/``wts`` over ``table``, scored against
    ``users`` when given (see the module's note).  An id outside the rows,
    or a feature id outside the table, reads NaN on the card."""
    _check_args(table, idx, wts, ids, scale, users)
    if table.device.type == "cpu":
        return feature_sums_plain(table, idx, wts, ids, scale, users)
    N, W = ids.shape[0], table.shape[1]
    B = users.shape[0] if users is not None else N
    C = N // B if users is not None and B else 1
    reps = torch.empty((N, W), dtype=torch.float32, device=table.device)
    scores = (torch.empty((N // B if B else 0, B), dtype=torch.float32, device=table.device)
              if users is not None else None)
    if N == 0 or W == 0:
        return reps, scores
    tensor_scale = isinstance(scale, torch.Tensor)
    code = _lib().feature_sums_launch(
        reps.data_ptr(), scores.data_ptr() if scores is not None else None,
        table.data_ptr(), idx.data_ptr(), wts.data_ptr(), ids.data_ptr(),
        users.data_ptr() if users is not None else None,
        scale.data_ptr() if tensor_scale else None,
        1.0 if scale is None or tensor_scale else float(scale),
        B, C, idx.shape[1], W, idx.shape[0], table.shape[0],
        ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream),
    )
    if code:
        msg = _lib().feature_sums_error_string(code).decode()
        raise RuntimeError(f"feature_sums kernel launch failed: {msg} (cudaError {code})")
    launches["feature_sums"] += 1
    observability.count("feature_sum_rows", N)
    return reps, scores
