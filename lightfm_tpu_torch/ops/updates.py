"""Sparse batched optimizer updates (adagrad / adadelta) with lazy L2.

Counterpart of ``lightfm_tpu/ops/updates.py:43`` (``sparse_update``), the
update of the generic training path, in plain PyTorch.  A minibatch of
"touches" ``(row idx, feature weight w, gradient g, mask)`` is applied to
one table at once:

- duplicates within a batch accumulate (scatter-add);
- masked touches are exact no-ops: they add 0 and multiply by exactly 1;
- adagrad reads the PRE-batch accumulator for every touch,
  ``lr_local = lr * rsqrt(acc[idx])``, then ``acc += (w*g)^2``;
- adadelta follows the JAX code (not its module docstring): ``acc`` and
  ``mom`` are multiplied by ``rho`` once per unmasked touch, so a row
  touched c times decays by ``rho^c``, and ``lr_local`` reads the updated
  accumulator (``_lightfm_fast.pyx.template:359-374, 417-434``);
- lazy L2 multiplies touched rows by ``1 + alpha * lr_local`` once per
  touch (template:372,387,432,447); the global scale bookkeeping lives in
  :mod:`lightfm_tpu_torch.losses` and :mod:`lightfm_tpu_torch.state`.

Under a row or component partition each rank applies only the touches of
the part it holds (``parallel.mesh.TablePlacement.own``), after every
rank has gathered the whole batch's touches: a touch of another rank's
row becomes a masked touch of a row held here, so each held row sees its
touches in the single-device order.

The JAX function also has a small-table branch that swaps the scatters for
one-hot matmuls (``updates.py:89-107``).  It exists only because scatters
serialize on XLA:TPU; it gives the same sums in another order and returns
zero statistics, which nothing reads (it runs only when no alpha is set).
It is left out here: one function covers both of its regimes.

Determinism on CUDA: the adagrad branch sums through the hand-written
kernel :func:`~lightfm_tpu_torch.ops.adagrad_update.touch_adagrad_update`,
one stable sort of the table's touches (:func:`touch_order`: a masked touch
keyed past the last row, so the kernel skips it) and one kernel that sums
each row's touches in fp32, in touch order, in chunks aligned to the row's
first touch, with no atomics.  A row's sums therefore depend only on its
own unmasked touches in touch order, not on where its run lands in the
sorted array: the touches that a row partition masks and the columns that
a component partition leaves to other ranks change no bit of a held row,
so both partitions stay bitwise the one-device update.  The adadelta
branch, which interleaves decays with its adds, goes through
:func:`scatter_add` (``index_put_(accumulate=True)``, which sums each
row's duplicates in a fixed order; a component partition's columns add in
the whole width's order, :func:`accumulate_rows`).  The
scatter-multiplies (``index_reduce_(..., "prod")``) use atomics on CUDA,
so their order changes from run to run, yet the result does not: every
unmasked factor of a given (row, column) is the same bit pattern (``rho``,
or ``1 + alpha * lr_local`` where ``lr_local`` depends on the row and
column only), and a masked factor is exactly 1.0, so any order of the
multiplications rounds the same way.  On the CPU every sum is
``index_add_`` in touch order.
"""

from __future__ import annotations

import warnings

import torch

from lightfm_tpu_torch.ops.adagrad_update import touch_adagrad_update

# index_reduce_ warns once per process that its API is in beta.
warnings.filterwarnings("ignore", message=r"index_reduce\(\) is in beta")


# PyTorch's CUDA ``index_put_(accumulate=True)`` adds a row's duplicates to
# the target one by one, ``(t + v1) + v2``, when a row has more than this
# many elements, but sums them first, ``t + (v1 + v2)``, when it has this
# many or fewer (its small-stride kernel): the two round differently.
_SMALL_ROW = 32


def scatter_add(target: torch.Tensor, rows: torch.Tensor, values: torch.Tensor,
                full_width: int | None = None) -> None:
    """``target[rows] += values`` in place, duplicates summed in a fixed
    order.  On CUDA ``index_add_`` uses atomics (its fp32 order changes from
    run to run) while ``index_put_(accumulate=True)`` sorts the indices and
    sums each row serially; on the CPU it is the other way round.

    ``full_width``: ``target`` holds some columns of a table that wide (a
    component partition).  Its rows then add as the whole table's would
    (``accumulate_rows``), so a split table stays bitwise one device's."""
    if target.is_cuda:
        accumulate_rows(target, rows, values, full_width)
    else:
        target.index_add_(0, rows, values)


def accumulate_rows(target: torch.Tensor, rows: torch.Tensor, values: torch.Tensor,
                    full_width: int | None = None) -> None:
    """``target.index_put_((rows,), values, accumulate=True)``; when
    ``target``'s rows are at most ``_SMALL_ROW`` wide but ``full_width``'s
    are wider, through a copy padded past ``_SMALL_ROW`` columns, so that
    the duplicates add in the whole width's order (the pad columns add
    zeros and are dropped)."""
    width = target.shape[1] if target.dim() == 2 else 1
    if full_width is None or not width <= _SMALL_ROW < full_width:
        target.index_put_((rows,), values, accumulate=True)
        return
    pad = (0, _SMALL_ROW + 1 - width)
    wide = torch.nn.functional.pad(target.reshape(-1, width), pad)
    wide.index_put_((rows,), torch.nn.functional.pad(values.reshape(-1, width), pad),
                    accumulate=True)
    target.copy_(wide[:, :width].reshape(target.shape))


def scatter_mul(target: torch.Tensor, rows: torch.Tensor, factors: torch.Tensor) -> None:
    """``target[rows] *= factors`` in place, once per touch.  Bitwise
    independent of order only for factors that are equal per (row, column)
    or exactly 1.0 (see the module docstring)."""
    target.index_reduce_(0, rows, factors, "prod")


def touch_order(idx: torch.Tensor, mask: torch.Tensor, n_rows: int):
    """The sorted keys (int32) and the order (int64) of one table's touches
    for :func:`~lightfm_tpu_torch.ops.adagrad_update.touch_adagrad_update`:
    each touch keyed by its row and a masked one by ``n_rows``, past the
    last row, sorted stably so that a row's touches keep their order."""
    keys = torch.where(mask, idx, n_rows).to(torch.int32)
    return torch.sort(keys, stable=True)


def kernel_sums(table: torch.Tensor, adadelta: bool) -> bool:
    """Whether :func:`sparse_update` sums ``table``'s touches through
    :func:`~lightfm_tpu_torch.ops.adagrad_update.touch_adagrad_update`:
    adagrad on a CUDA table."""
    return table.is_cuda and not adadelta


def sparse_update(
    table: torch.Tensor,  # [R, W] or [R]
    acc: torch.Tensor,
    mom: torch.Tensor,
    idx: torch.Tensor,  # int [M]
    w: torch.Tensor,  # f32 [M] feature weights
    g: torch.Tensor,  # f32 [M, W] or [M] per-touch gradients
    mask: torch.Tensor,  # bool [M]; False touches are no-ops
    *,
    adadelta: bool,
    learning_rate: float,
    alpha: float,
    rho: float,
    eps: float,
    emb_dim: int | None = None,
    need_stats: bool = True,
    col_offset: int = 0,
    full_width: int | None = None,
):
    """Apply one batched sparse optimizer step to ``table``, in place.

    Returns ``(table, acc, mom, sum_local_lr, n_touches)``; the last two
    sum over unmasked (touch, column) pairs, counting only the active
    columns ``[0, emb_dim)`` and the bias column of a width-padded table
    (all columns when ``emb_dim`` is None).  ``need_stats=False`` skips
    them and returns None for both.  A table that holds columns
    ``[col_offset, col_offset + W)`` of a ``full_width`` table (a
    component partition) counts its active columns by their global index.

    Adagrad on a CUDA table sums through the hand-written kernel
    (:func:`kernel_sums`; see the module docstring).
    """
    squeeze = table.dim() == 1
    if squeeze:
        table, acc, mom, g = table[:, None], acc[:, None], mom[:, None], g[:, None]
    W = table.shape[1]
    idx = idx.long()
    mask_f = mask.to(table.dtype)[:, None]  # [M, 1]
    wg = (w * mask.to(w.dtype))[:, None] * g  # [M, W]; masked touches add 0

    if not adadelta:
        # adagrad (template:376-389, 436-449).
        lr_local = learning_rate * torch.rsqrt(acc[idx])  # [M, W]
        if kernel_sums(table, adadelta):
            skeys, order = touch_order(idx, mask, table.shape[0])
            touch_adagrad_update(table, acc, skeys, order, wg, learning_rate)
        else:
            scatter_add(table, idx, -(lr_local * wg), full_width)
            scatter_add(acc, idx, wg * wg, full_width)
    else:
        # adadelta (template:359-374, 417-434).
        decay = torch.where(mask, rho, 1.0).to(table.dtype)[:, None].expand_as(wg).contiguous()
        scatter_mul(acc, idx, decay)
        scatter_add(acc, idx, (1.0 - rho) * wg * wg, full_width)
        lr_local = torch.sqrt(mom[idx] + eps) * torch.rsqrt(acc[idx] + eps)
        update = lr_local * wg
        scatter_mul(mom, idx, decay)
        scatter_add(mom, idx, (1.0 - rho) * update * update, full_width)
        scatter_add(table, idx, -update, full_width)

    if alpha != 0.0:
        # Lazy regularisation boost; masked touches get factor exactly 1.
        scatter_mul(table, idx, 1.0 + alpha * lr_local * mask_f)

    W_all = W if full_width is None else full_width
    if not need_stats:
        sum_lr = n_touches = None
    elif emb_dim is not None and emb_dim + 1 < W_all:
        cols = col_offset + torch.arange(W, device=table.device)
        col_active = ((cols < emb_dim) | (cols == W_all - 1)).to(table.dtype)
        sum_lr = torch.sum(lr_local * mask_f * col_active[None, :])
        n_active = (max(0, min(emb_dim, col_offset + W) - col_offset)
                    + int(col_offset <= W_all - 1 < col_offset + W))
        n_touches = torch.sum(mask_f) * n_active
    else:
        sum_lr = torch.sum(lr_local * mask_f)
        n_touches = torch.sum(mask_f) * W
    if squeeze:
        table, acc, mom = table[:, 0], acc[:, 0], mom[:, 0]
    return table, acc, mom, sum_lr, n_touches
