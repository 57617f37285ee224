"""Operations of top-k recommendation over a whole catalog, from shapes."""

from __future__ import annotations


def user_flops(I: int, D: int) -> float:
    """Model FLOPs of scoring one user against a catalog of ``I`` items:
    ``2 (D + 2)`` a scored item (``D`` products and their sum, the two
    biases added).  The top-k and the exclusion are compares."""
    return 2.0 * I * (D + 2)
