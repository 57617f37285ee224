"""Fused catalog scoring + rank counting: the Hopper kernel and its plain versions.

Counterpart of ``lightfm_tpu/ops/pallas_rank.py:63`` (``rank_counts_fused``)
and of the diagonal-GEMM score extraction ``lightfm_tpu/ops/ranking.py:293``
(``_diag_scores``).  The kernels live in ``csrc/rank_counts.cu``; they are
built at first use by :mod:`lightfm_tpu_torch.ops._build` and called through
ctypes on PyTorch's current stream.

Bound of :func:`rank_counts` on the card: ``2*U*I*Wa`` fp32 FLOP plus
``U*I*T`` compares on the FP32 CUDA cores, whose rate is SM count x 128
lanes x 2 x clock (about 67 TFLOP/s on an H100 SXM at 700 W); the bytes
(the inputs once, the counts once) are three orders of magnitude smaller.
The simple design stages user and item tiles in shared memory and reads
both operands from there for every FMA, so it runs at the shared-memory
issue rate, several times below that bound; see the source for the layout.

Each wrapper takes its plain version only for tensors on the CPU.  A CUDA
tensor launches the kernel or raises; there is no fallback.  ``launches``
counts kernel launches (never plain-version calls), so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from lightfm_tpu_torch.ops import _build
from lightfm_tpu_torch.ops.representation import f32_dot

# Largest test-slot count the counting kernel takes (its register tiles).
MAX_T = 32

launches = {"rank_counts": 0, "pair_scores": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("rank_counts")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rank_counts_launch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.rank_counts_launch.restype = i
        lib.pair_scores_launch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.pair_scores_launch.restype = i
        lib.rank_counts_error_string.argtypes = [i]
        lib.rank_counts_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_launch(lib, code: int, name: str) -> None:
    if code:
        msg = lib.rank_counts_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {code})")


def _check(name: str, x: torch.Tensor, dtype, ndim: int, device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _score_chunks(u_aug: torch.Tensor, items_aug: torch.Tensor, chunk_elems: int = 1 << 28):
    """Yield ``(rows, u_aug[rows] @ items_aug.T)`` over user chunks (IEEE
    fp32).  Both plain versions score through here with the same chunks,
    so a score they share is bitwise the same, as on the card."""
    step = max(1, chunk_elems // max(1, items_aug.shape[0]))
    for a in range(0, u_aug.shape[0], step):
        yield slice(a, a + step), f32_dot(u_aug[a : a + step], items_aug.T)


def rank_counts_plain(
    u_aug: torch.Tensor, items_aug: torch.Tensor, ts: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`rank_counts`: chunked ``u_aug @ items_aug.T``
    and a ``>=`` count per test slot."""
    out = torch.empty(ts.shape, dtype=torch.float32, device=ts.device)
    for rows, s in _score_chunks(u_aug, items_aug):
        for t in range(ts.shape[1]):
            out[rows, t] = (s >= ts[rows, t : t + 1]).sum(1)
    return out


def rank_counts(
    u_aug: torch.Tensor, items_aug: torch.Tensor, ts: torch.Tensor
) -> torch.Tensor:
    """``counts[u, t] = #{i : u_aug[u] . items_aug[i] >= ts[u, t]}``, f32.

    ``u_aug`` f32 [U, Wa], ``items_aug`` f32 [I, Wa] (pad rows score -inf),
    ``ts`` f32 [U, T] (+inf in invalid slots, which then count 0).  On the
    card the kernel takes T <= 32 and any Wa or I.
    """
    dev = u_aug.device
    _check("u_aug", u_aug, torch.float32, 2, dev)
    _check("items_aug", items_aug, torch.float32, 2, dev)
    _check("ts", ts, torch.float32, 2, dev)
    U, Wa = u_aug.shape
    I, T = items_aug.shape[0], ts.shape[1]
    if items_aug.shape[1] != Wa or ts.shape[0] != U:
        raise ValueError(
            f"shape mismatch: u_aug {tuple(u_aug.shape)}, items_aug "
            f"{tuple(items_aug.shape)}, ts {tuple(ts.shape)}"
        )
    if dev.type == "cpu":
        return rank_counts_plain(u_aug, items_aug, ts)
    if dev.type != "cuda":
        raise ValueError(f"rank_counts runs on CUDA or CPU tensors, not {dev}")
    if T > MAX_T:
        raise ValueError(f"rank_counts kernel takes T <= {MAX_T}, got {T}")
    counts = torch.empty((U, T), dtype=torch.int32, device=dev)
    if U == 0 or T == 0:
        return counts.to(torch.float32)
    lib = _lib()
    code = lib.rank_counts_launch(
        u_aug.data_ptr(), items_aug.data_ptr(), ts.data_ptr(), counts.data_ptr(),
        U, I, Wa, T, _stream(dev),
    )
    _check_launch(lib, code, "rank_counts")
    launches["rank_counts"] += 1
    return counts.to(torch.float32)


def pair_scores_plain(
    u_aug: torch.Tensor, items_aug: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`pair_scores`: the scores are read out of the
    same chunked matmuls :func:`rank_counts_plain` counts, so a test item's
    score is bitwise its own catalog score there, as with the kernels."""
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    for rows, s in _score_chunks(u_aug, items_aug):
        out[rows] = s.gather(1, idx[rows].long())
    return out


def pair_scores(
    u_aug: torch.Tensor, items_aug: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """``out[u, c] = u_aug[u] . items_aug[idx[u, c]]``, f32 [U, C].

    On the card every score is bitwise the one :func:`rank_counts` computes
    for the same (user, item) pair: both kernels call one device routine.
    ``idx`` is int32 in ``[0, I)``; the kernel writes NaN for an index
    outside it instead of reading out of bounds.
    """
    dev = u_aug.device
    _check("u_aug", u_aug, torch.float32, 2, dev)
    _check("items_aug", items_aug, torch.float32, 2, dev)
    _check("idx", idx, torch.int32, 2, dev)
    U, Wa = u_aug.shape
    I, C = items_aug.shape[0], idx.shape[1]
    if items_aug.shape[1] != Wa or idx.shape[0] != U:
        raise ValueError(
            f"shape mismatch: u_aug {tuple(u_aug.shape)}, items_aug "
            f"{tuple(items_aug.shape)}, idx {tuple(idx.shape)}"
        )
    if dev.type == "cpu":
        return pair_scores_plain(u_aug, items_aug, idx)
    if dev.type != "cuda":
        raise ValueError(f"pair_scores runs on CUDA or CPU tensors, not {dev}")
    out = torch.empty((U, C), dtype=torch.float32, device=dev)
    if U == 0 or C == 0:
        return out
    lib = _lib()
    code = lib.pair_scores_launch(
        u_aug.data_ptr(), items_aug.data_ptr(), idx.data_ptr(), out.data_ptr(),
        U, C, I, Wa, _stream(dev),
    )
    _check_launch(lib, code, "pair_scores")
    launches["pair_scores"] += 1
    return out
