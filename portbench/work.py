"""Operations and bytes of the model and of each hand-written kernel, from
shapes, against the published peaks of one NVIDIA H100 SXM.

The kernels' bounds are frozen copies of the formulas in ``PERF.md``'s
kernel table (``chip_smoke.py``'s ``update_bound_ms`` and K2's bound).  A share of a roofline or of a peak is computed here and
returned unrounded.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense float32 outside the tensor cores, and
# the HBM3 rate.  Both assume the card's full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def warp_example_flops(D: int, K: int) -> float:
    """Model FLOPs of one WARP example with identity features at the
    model's width ``D`` (not the padded table width), with ``K`` sampled
    candidates:

    - ``K + 1`` scores, each a ``D + 1``-term dot product (the bias rides
      as one term): ``2 (K + 1) (D + 1)``;
    - the pair's gradient rows (positive, negative, user): ``4 (D + 1)``;
    - the adagrad move of the three touched rows (user, positive,
      negative), 6 FLOPs an entry (square, accumulate, rsqrt, two
      multiplies, subtract): ``18 (D + 1)``.

    The count does not depend on how the program implements the step.
    """
    return float((2 * (K + 1) + 4 + 18) * (D + 1))


def rank_call_flops(U: int, I: int, D: int, T: int) -> float:
    """Model operations of ranking ``T`` test items for each of ``U`` users
    against a catalog of ``I`` items: ``2D + 2`` FLOPs a scored (user,
    item) pair plus one compare per pair and test item."""
    return float(U) * I * (2 * D + 2) + float(U) * I * T


def k1_bound_s(M: int, W: int, distinct: int) -> float:
    """K1 (``sorted_adagrad_update``): the touches (ids and gradient rows)
    read once, and table and accumulator read and written once for each
    distinct touched row, over the HBM rate."""
    return (4.0 * M * (W + 1) + 16.0 * W * distinct) / PEAK_HBM_BYTES_PER_S


def k2_bound_s(U: int, I: int, Wa: int, T: int) -> float:
    """K2 (``rank_counts``): the larger of its operations (``2 U I Wa``
    FLOPs and ``U I T`` compares) over the fp32 peak and its bytes (users,
    catalog and thresholds read, counts written) over the HBM rate."""
    ops = 2.0 * U * I * Wa + float(U) * I * T
    nbytes = 4.0 * (U * Wa + I * Wa + 2 * U * T)
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def share_pct(part: float, whole: float):
    """``100 * part / whole``, or None when there is nothing to divide by."""
    if not whole or whole <= 0:
        return None
    return 100.0 * part / whole
