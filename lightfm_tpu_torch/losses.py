"""Minibatch container of the training steps.

Counterpart of ``lightfm_tpu/losses.py:51``.  The generic (non-fast) step
functions of that module are not ported yet (ROADMAP.md); the fast path's
steps live in :mod:`lightfm_tpu_torch.fast_warp`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Batch(NamedTuple):
    user_ids: torch.Tensor  # int32 [B]
    item_ids: torch.Tensor  # int32 [B]
    y: torch.Tensor  # f32 [B]
    weight: torch.Tensor  # f32 [B]
    valid: torch.Tensor  # bool [B]
