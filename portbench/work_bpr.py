"""Operations of the BPR model's step under adagrad with lazy L2 on both
tables (identity features), from shapes.  Nothing here depends on how the
program implements the step."""

from __future__ import annotations

from portbench.work_kos import L2_FLOPS

# FLOPs an entry of one adagrad move (template:376-389): the square, its
# accumulation, the reciprocal square root, two multiplies, the subtraction.
ADAGRAD_FLOPS = 6


def flops_per_example(D: int) -> float:
    """Model FLOPs of one BPR example at the model's width ``D`` (not the
    padded table width):

    - two scores, the positive's and the negative's, each a ``D + 1``-term
      dot product (the bias rides as one term): ``4 (D + 1)``;
    - the pair's gradient rows (positive, negative, user): ``4 (D + 1)``;
    - the adagrad move and the L2 multiply of the three touched rows:
      ``3 (ADAGRAD_FLOPS + L2_FLOPS) (D + 1)``.

    The tries' test against the user's positives is compares, not FLOPs."""
    return float((4 + 4 + 3 * (ADAGRAD_FLOPS + L2_FLOPS)) * (D + 1))
