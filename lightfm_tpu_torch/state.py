"""Model state: eight tensors in the JAX package's layout.

Counterpart of ``lightfm_tpu/state.py:42-158``.  Biases are fused into the
embedding tables as the LAST column and the table width is padded to a
multiple of 8 with zero columns between the embeddings and the bias
(``[emb 0..D-1 | zeros | bias]``), so states compare element-wise with the
JAX package's and checkpoints load in either.  Zero columns are exact
no-ops in every dot product.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Rescale threshold for the lazy-regularisation accumulators, mirroring
# MAX_REG_SCALE in the reference (`_lightfm_fast.pyx.template:19`); scales
# are tracked in log space.
MAX_REG_SCALE = 1e6
LOG_MAX_REG_SCALE = float(np.log(MAX_REG_SCALE))


class ModelState(NamedTuple):
    """All trainable state.

    ``*_table``: [n_features, W] with W = table_width(D) -- embedding
    columns 0..D-1, zero-padding columns D..W-2, bias column W-1.
    ``*_acc``: adagrad/adadelta squared-gradient accumulators (same shape).
    ``*_mom``: adadelta squared-update moving averages.
    ``*_log_scale``: 0-d f32 tensors, log of the lazy-L2 scale.
    """

    item_table: torch.Tensor
    item_acc: torch.Tensor
    item_mom: torch.Tensor
    user_table: torch.Tensor
    user_acc: torch.Tensor
    user_mom: torch.Tensor
    item_log_scale: torch.Tensor
    user_log_scale: torch.Tensor


def table_width(no_components: int) -> int:
    """Fused-table width: D embedding cols + bias col, rounded up to 8."""
    return ((no_components + 1 + 7) // 8) * 8


def _make_table(gen: torch.Generator, n: int, D: int, W: int, device) -> torch.Tensor:
    """[n, W] table: (U[0,1) - 0.5) / D in cols 0..D-1, zeros after."""
    table = torch.zeros((n, W), dtype=torch.float32, device=device)
    # In place: the same values as (rand - 0.5) / D, with one temporary.
    table[:, :D] = torch.rand((n, D), generator=gen, device=device).sub_(0.5).div_(D)
    return table


def init_state(
    no_components: int,
    no_item_features: int,
    no_user_features: int,
    random_state: np.random.RandomState,
    adagrad: bool,
    device="cpu",
    share_seed=None,
    part=None,
) -> ModelState:
    """Initialise latent state on ``device``.

    The reference's distribution (`lightfm/lightfm.py:281-312`): embeddings
    ~ (U[0,1) - 0.5)/no_components in float32, biases zero, adagrad
    accumulators start at 1.  The seed is drawn from the numpy RandomState
    exactly as the JAX package draws it, then feeds a ``torch.Generator``
    on the device, so the numbers differ from ``jax.random``'s but seeded
    runs stay deterministic.

    Under a mesh, ``share_seed`` maps the seed drawn here to the one every
    rank uses (rank 0's), and ``part(field, whole)`` cuts each table to the
    part this rank holds as soon as it is drawn, so the device holds one
    whole table at a time and the accumulators only at part size.
    """
    D = no_components
    W = table_width(D)
    seed = int(random_state.randint(0, np.iinfo(np.int32).max))
    if share_seed is not None:
        seed = share_seed(seed)
    gen = torch.Generator(device=device).manual_seed(seed)

    def cut(field, whole):
        return whole if part is None else part(field, whole)

    # Reference init order: item embeddings first, then user (lightfm.py:287-306).
    item = cut("item_table", _make_table(gen, no_item_features, D, W, device))
    user = cut("user_table", _make_table(gen, no_user_features, D, W, device))
    grad_init = 1.0 if adagrad else 0.0
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return ModelState(
        item_table=item,
        item_acc=torch.full_like(item, grad_init),
        item_mom=torch.zeros_like(item),
        user_table=user,
        user_acc=torch.full_like(user, grad_init),
        user_mom=torch.zeros_like(user),
        item_log_scale=zero,
        user_log_scale=zero.clone(),
    )


def _fold(table: torch.Tensor, log_scale: torch.Tensor) -> torch.Tensor:
    inv = torch.exp(-log_scale)
    out = table * inv
    return torch.where(torch.isinf(table) & (inv == 0.0), torch.zeros_like(out), out)


def fold_scales(state: ModelState) -> ModelState:
    """Fold the lazy-regularisation scales into the tables and reset them.

    ``regularize`` in the reference (`_lightfm_fast.pyx.template:652-675`).
    ``exp(-log_scale)`` underflows to an exact 0 for extreme accumulations;
    an inf table entry times that 0 is patched to 0 (the reference's limit),
    while a genuine NaN stays NaN.
    """
    zero = torch.zeros_like(state.item_log_scale)
    return state._replace(
        item_table=_fold(state.item_table, state.item_log_scale),
        user_table=_fold(state.user_table, state.user_log_scale),
        item_log_scale=zero,
        user_log_scale=zero.clone(),
    )


def maybe_fold_scales(state: ModelState) -> ModelState:
    """Fold when a scale accumulator grew past MAX_REG_SCALE
    (``locked_regularize``, template:678-691), decided on the device: the
    fold runs with both log scales replaced by 0 where it is not needed,
    and ``exp(-0) = 1`` leaves every entry as it is, so the result is
    bitwise fold-or-not with no host sync."""
    needs = (state.item_log_scale > LOG_MAX_REG_SCALE) | (
        state.user_log_scale > LOG_MAX_REG_SCALE
    )
    zero = torch.zeros_like(state.item_log_scale)
    item_log = torch.where(needs, state.item_log_scale, zero)
    user_log = torch.where(needs, state.user_log_scale, zero)
    return state._replace(
        item_table=_fold(state.item_table, item_log),
        user_table=_fold(state.user_table, user_log),
        item_log_scale=torch.where(needs, zero, state.item_log_scale),
        user_log_scale=torch.where(needs, zero, state.user_log_scale),
    )
