"""Operations and bytes of the hybrid WARP model's step (item features, lazy
L2), from shapes and the data's tag counts, against the published peaks in
:mod:`portbench.work`.

``t_pos`` is the mean count of features of a training positive (the
interactions' items, counted with their multiplicity) and ``t_neg`` that
of a candidate, drawn uniformly from the catalog.  Neither count includes
padding.  Nothing here depends on how the program implements the step.
"""

from __future__ import annotations

from portbench.work import PEAK_FP32_FLOPS, PEAK_HBM_BYTES_PER_S


def score_flops(D: int, K: int, t_pos: float, t_neg: float) -> float:
    """Model FLOPs of one example's scoring: the feature sums of its
    positive and its ``K`` candidates, ``2 (D + 1)`` a feature (a
    multiply-add of each of the row's ``D + 1`` active entries), and ``K +
    1`` scores of ``D + 1`` terms."""
    return 2.0 * (D + 1) * (t_pos + K * t_neg) + 2.0 * (K + 1) * (D + 1)


def example_flops(D: int, K: int, t_pos: float, t_neg: float, item_l2: bool,
                  user_l2: bool) -> float:
    """Model FLOPs of one hybrid WARP example with identity users:

    - its scoring (:func:`score_flops`);
    - the pair's gradient rows (positive, violator, user): ``4 (D + 1)``;
    - the adagrad move of the user row and of the positive's and the
      violator's feature rows, 6 FLOPs an entry (square, accumulate,
      rsqrt, two multiplies, subtract), and where that side has L2 the
      multiply by ``1 + alpha lr_local``, 3 more (multiply, add,
      multiply): ``(6 + 3 user_l2) (D + 1) + (6 + 3 item_l2) (D + 1)
      (t_pos + t_neg)``.
    """
    update = ((6 + 3 * user_l2) * (D + 1)
              + (6 + 3 * item_l2) * (D + 1) * (t_pos + t_neg))
    return float(score_flops(D, K, t_pos, t_neg) + 4 * (D + 1) + update)


def score_bytes(B: int, K: int, W: int, t_pos: float, t_neg: float, n_features: int) -> float:
    """Bytes a step's scoring must move at least: each candidate's feature
    ids and weights (4 bytes each, real features only), the users' rows
    (``W`` floats each) and the feature table once."""
    return (8.0 * B * (t_pos + K * t_neg) + 4.0 * B * W + 4.0 * n_features * W)


def score_bound_s(B: int, K: int, D: int, W: int, t_pos: float, t_neg: float,
                  n_features: int) -> float:
    """The least time of a step's scoring on the chip: the larger of its
    FLOPs over the fp32 peak and its bytes over the HBM rate."""
    return max(B * score_flops(D, K, t_pos, t_neg) / PEAK_FP32_FLOPS,
               score_bytes(B, K, W, t_pos, t_neg, n_features) / PEAK_HBM_BYTES_PER_S)
