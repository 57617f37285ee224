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
The kernel is a register-tiled fp32 scorer: each thread keeps an 8 (or 4)
users x 8 items tile of scores in registers, so four float4 shared-memory
loads feed 64 FMAs, over k-major operands this wrapper stages
(``u_aug.T``, ``items_aug.T``, each padded to a multiple of 4 columns),
with the item tiles double-buffered by ``cp.async``.  The user tile stays
resident in shared memory, or, at rows too wide for two blocks an SM, is
staged chunk by chunk beside the items, so any width runs.  Every score
keeps row_dot's FMA chain, bitwise what :func:`pair_scores` computes.  The grid is (user
tiles x item splits); :func:`launch_plan` picks the split so that the card
fills at any user count.  :func:`pair_scores` runs blocks of 128
consecutive (user, slot) pairs that stage their gathered rows into shared
memory with coalesced copies before each thread runs its chain
(:func:`pair_plan`).  See the source for the layouts.

Each wrapper takes its plain version only for tensors on the CPU.  A CUDA
tensor launches the kernel or raises; there is no fallback.  ``launches``
counts kernel launches (never plain-version calls), so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from lightfm_tpu_torch import observability
from lightfm_tpu_torch.ops import _build
from lightfm_tpu_torch.ops.representation import f32_dot

# Largest test-slot count the counting kernel takes (its register tiles).
MAX_T = 32
# The kernel's layout (csrc/rank_counts.cu): 64-item tiles, item chunks of
# at most 80 k-rows in two buffers, and the shared memory of one SM (228 KB,
# of it at most 227 KB for a block, 1 KB reserved per resident block).
BLOCK_ITEMS = 64
MAX_CHUNK_ROWS = 80
MAX_BLOCK_SMEM = 232_448
SM_SMEM = 233_472
# pair_scores: (user, slot) pairs a block owns (kPairs in the source).
PAIR_BLOCK = 128

launches = {"rank_counts": 0, "pair_scores": 0}


class KernelShape(NamedTuple):
    block_users: int  # users per block: 16 x the thread tile's 8 or 4
    t_pad: int  # test slots the template compares (T padded with +inf)
    chunk_rows: int  # k-rows of a staged item chunk
    smem_bytes: int
    blocks_per_sm: int
    stream_users: bool  # the user tile staged chunk by chunk, not resident


class LaunchPlan(NamedTuple):
    user_tiles: int
    item_splits: int
    tiles_per_split: int  # 64-item tiles each split walks (the last may walk fewer)

    @property
    def blocks(self) -> int:
        return self.user_tiles * self.item_splits


def kernel_shape(T: int, Wa: int) -> KernelShape:
    """The template and shared-memory layout of one launch.  An 8-user
    thread tile keeps 8 x t_pad counters and 64 scores in registers, so it
    takes t_pad <= 12 and rows up to 128 wide (two blocks per SM); wider
    slot counts or rows take the 4-user tile (t_pad >= 16).  The user tile
    stays resident while two blocks of it fit on an SM; past that it is
    staged in two buffers of ``chunk_rows`` k-rows, as the items are, so
    two blocks fit at any ``Wa``."""
    if not 1 <= T <= MAX_T:
        raise ValueError(f"rank_counts kernel takes 1 <= T <= {MAX_T}, got {T}")
    if Wa < 1:
        raise ValueError(f"rank_counts kernel takes Wa >= 1, got {Wa}")
    t_pad = T if T <= 2 else -(-T // 4) * 4
    block_users = 128
    if t_pad > 12 or Wa > 128:
        block_users, t_pad = 64, max(t_pad, 16)
    n_chunks = -(-Wa // MAX_CHUNK_ROWS)
    kc = -(-Wa // n_chunks)

    def smem(user_rows):
        return 4 * (block_users * t_pad + user_rows * block_users + 2 * kc * BLOCK_ITEMS)

    stream = SM_SMEM // (smem(Wa) + 1024) < 2
    size = smem(2 * kc if stream else Wa)
    return KernelShape(block_users, t_pad, kc, size, min(2, SM_SMEM // (size + 1024)), stream)


@functools.lru_cache(maxsize=256)
def launch_plan(U: int, I: int, n_sms: int, blocks_per_sm: int, block_users: int = 128) -> LaunchPlan:
    """Split the catalog so that the (user tiles x item splits) grid fills
    the card.  Each split walks a contiguous run of whole item tiles, none
    empty.  The cost of a plan is its waves of ``n_sms * blocks_per_sm``
    blocks times the tiles a block walks, plus the user tile it loads
    (``block_users / BLOCK_ITEMS`` tiles' worth); the cheapest plan with at
    least ``min(n_sms, user tiles x item tiles)`` blocks wins, the fewer
    splits on a tie (fewer atomics)."""
    user_tiles = max(1, -(-U // block_users))
    item_tiles = max(1, -(-I // BLOCK_ITEMS))
    slots = n_sms * blocks_per_sm
    need = min(n_sms, user_tiles * item_tiles)
    best = None
    for per_split in range(1, item_tiles + 1):
        splits = -(-item_tiles // per_split)
        blocks = user_tiles * splits
        if blocks < need:
            continue
        cost = -(-blocks // slots) * (per_split + block_users / BLOCK_ITEMS)
        key = (cost, splits)
        if best is None or key < best[0]:
            best = (key, LaunchPlan(user_tiles, splits, per_split))
    return best[1]


class PairPlan(NamedTuple):
    chunk_cols: int  # columns of a staged chunk
    stride: int  # floats between staged rows: 4 x odd, >= chunk_cols
    users: int  # most users one block's pairs span
    smem_bytes: int
    blocks: int


@functools.lru_cache(maxsize=256)
def pair_plan(U: int, C: int, Wa: int) -> PairPlan:
    """The launch of :func:`pair_scores` (``csrc/rank_counts.cu``): blocks
    of ``PAIR_BLOCK`` consecutive pairs of the flat ``[U, C]`` output, each
    staging its gathered item rows and its users' rows in chunks of at most
    ``MAX_CHUNK_ROWS`` columns (the fewest chunks, evened out), ``stride``
    floats apart.  The kernel's shared memory: the block's item ids, then
    ``PAIR_BLOCK + users`` staged rows."""
    if U < 1 or C < 1 or Wa < 1:
        raise ValueError(f"pair_plan takes U, C, Wa >= 1, got {U}, {C}, {Wa}")
    n_chunks = -(-Wa // MAX_CHUNK_ROWS)
    kc = -(-Wa // n_chunks)
    stride = 4 * (-(-kc // 4) | 1)  # float4 rows; 8 rows a quarter warp: 8 bank groups
    users = min(PAIR_BLOCK, (PAIR_BLOCK + C - 2) // C + 1)
    smem = 4 * (PAIR_BLOCK + (PAIR_BLOCK + users) * stride)
    return PairPlan(kc, stride, users, smem, -(-U * C // PAIR_BLOCK))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(U: int, I: int, T: int, Wa: int, device) -> tuple[KernelShape, LaunchPlan]:
    """The shape and plan :func:`rank_counts` launches with on ``device``."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    shape = kernel_shape(T, Wa)
    plan = launch_plan(U, I, _sm_count(index), shape.blocks_per_sm, shape.block_users)
    return shape, plan


def _k_major(x: torch.Tensor) -> torch.Tensor:
    """``x.T`` with its rows padded by zero columns to a multiple of 4
    (16-byte-aligned rows for ``cp.async``)."""
    n, Wa = x.shape
    out = x.new_zeros((Wa, -(-n // 4) * 4))
    out[:, :n] = x.T
    return out


def stage_k_major(u_aug: torch.Tensor, items_aug: torch.Tensor):
    """The kernel's operands: ``u_aug.T`` [Wa, ldu] and ``items_aug.T``
    [Wa, ldi], each padded to a multiple of 4 columns."""
    return _k_major(u_aug), _k_major(items_aug)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("rank_counts")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rank_counts_launch.argtypes = [p, p, p, p] + [i] * 13 + [p]
        lib.rank_counts_launch.restype = i
        lib.pair_scores_launch.argtypes = [p, p, p, p] + [i] * 6 + [p]
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


@observability.spanned("kernel.k2")
def rank_counts(
    u_aug: torch.Tensor, items_aug: torch.Tensor, ts: torch.Tensor
) -> torch.Tensor:
    """``counts[u, t] = #{i : u_aug[u] . items_aug[i] >= ts[u, t]}``, f32.

    ``u_aug`` f32 [U, Wa], ``items_aug`` f32 [I, Wa] (pad rows score -inf),
    ``ts`` f32 [U, T] (+inf in invalid slots, which then count 0).  On the
    card the kernel takes T <= 32 and any U, I or Wa.
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
    if U == 0 or T == 0 or I == 0:
        return torch.zeros((U, T), dtype=torch.float32, device=dev)
    shape, plan = plan_for(U, I, T, Wa, dev)  # raises for T > MAX_T
    counts = torch.zeros((U, T), dtype=torch.int32, device=dev)  # blocks add into it
    u_t, it_t = stage_k_major(u_aug, items_aug)
    lib = _lib()
    code = lib.rank_counts_launch(
        u_t.data_ptr(), it_t.data_ptr(), ts.data_ptr(), counts.data_ptr(),
        U, u_t.shape[1], I, it_t.shape[1], Wa, T, shape.block_users, shape.t_pad,
        shape.chunk_rows, int(shape.stream_users), plan.user_tiles, plan.item_splits,
        plan.tiles_per_split, _stream(dev),
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


@observability.spanned("kernel.pair_scores")
def pair_scores(
    u_aug: torch.Tensor, items_aug: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """``out[u, c] = u_aug[u] . items_aug[idx[u, c]]``, f32 [U, C].

    On the card every score is bitwise the one :func:`rank_counts` computes
    for the same (user, item) pair: both kernels run the same FMA chain.
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
    plan = pair_plan(U, C, Wa)
    lib = _lib()
    code = lib.pair_scores_launch(
        u_aug.data_ptr(), items_aug.data_ptr(), idx.data_ptr(), out.data_ptr(),
        U, C, I, Wa, plan.chunk_cols, plan.stride, _stream(dev),
    )
    _check_launch(lib, code, "pair_scores")
    launches["pair_scores"] += 1
    return out
