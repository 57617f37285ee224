"""Operations and bytes of the k-OS WARP model's step under adadelta with
lazy L2 on both tables (identity features), from shapes, against the
published peaks in :mod:`portbench.work`.  Nothing here depends on how the
program implements the step."""

from __future__ import annotations

from portbench.work import PEAK_HBM_BYTES_PER_S

# FLOPs an entry of one adadelta move (template:359-374): the square and
# its (1 - rho) share, the decay and the add of the accumulator; the two
# additions of eps, the square root, the reciprocal square root and their
# product (lr_local); the update; its square, its share, the decay and the
# add of the moment; the subtraction from the parameter.
ADADELTA_FLOPS = 15
# The lazy-L2 multiply: alpha * lr_local, the add of 1, the multiply.
L2_FLOPS = 3


def flops_per_example(D: int, K: int, n: int) -> float:
    """Model FLOPs of one k-OS example at the model's width ``D`` (not the
    padded table width), with ``n`` sampled positives and ``K`` sampled
    negatives:

    - ``n + K`` scores, each a ``D + 1``-term dot product (the bias rides
      as one term): ``2 (n + K) (D + 1)``;
    - the pair's gradient rows (positive, violator, user): ``4 (D + 1)``;
    - the adadelta move and the L2 multiply of the three touched rows:
      ``3 (ADADELTA_FLOPS + L2_FLOPS) (D + 1)``.

    The order of the sampled positives is compares, not FLOPs."""
    return float((2 * (n + K) + 4 + 3 * (ADADELTA_FLOPS + L2_FLOPS)) * (D + 1))


def adadelta_bound_s(M: int, W: int, distinct: int) -> float:
    """The least time of a step's adadelta passes: each of the ``M``
    active touches' id and ``W``-wide gradient read once, and each of the
    ``distinct`` rows' table, accumulator and moment read once and written
    once, over the HBM rate."""
    return (4.0 * M * (W + 1) + 24.0 * W * distinct) / PEAK_HBM_BYTES_PER_S
