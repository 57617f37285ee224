"""Static hyperparameter configuration.

A copy of ``lightfm_tpu/config.py:22-109``: the 12 constructor
hyperparameters of the reference model (``lightfm/lightfm.py:189-241``)
plus the JAX package's execution knobs.  Every field is kept, so
``get_params`` and checkpoints interchange between the two packages.  The
fast-path knobs steer ``fast_warp``; ``pool_kernels="kernels"`` is a
deprecated alias of ``"einsum"``.
"""

from __future__ import annotations

import dataclasses

LOSSES = ("logistic", "warp", "bpr", "warp-kos")
SCHEDULES = ("adagrad", "adadelta")

# Gradient clip applied to ranking losses, mirroring MAX_LOSS
# (`_lightfm_fast.pyx.template:817,884`).
MAX_LOSS = 10.0


@dataclasses.dataclass(frozen=True)
class Hyperparams:
    """Model hyperparameters."""

    no_components: int = 10
    k: int = 5
    n: int = 10
    learning_schedule: str = "adagrad"
    loss: str = "logistic"
    learning_rate: float = 0.05
    rho: float = 0.95
    epsilon: float = 1e-6
    item_alpha: float = 0.0
    user_alpha: float = 0.0
    max_sampled: int = 10

    # Minibatch size of the batched SGD reformulation; auto-chosen if None.
    batch_size: int | None = None
    # Number of candidate draws for BPR's rejection sampling of negatives.
    bpr_tries: int = 8

    # Fast training path knobs (see lightfm_tpu/config.py for their meaning).
    fast_path: str = "auto"  # "auto" | "on" | "off"
    pool_kernels: str = "auto"  # "auto" | "einsum" | "kernels" (deprecated)
    user_pallas: bool = True
    fast_precision: str = "default"  # "default" | "highest"
    shuffle_mode: str = "feistel"  # "feistel" | "sort"

    def __post_init__(self):
        # Mirror the reference's constructor asserts (`lightfm/lightfm.py:205-216`).
        assert self.item_alpha >= 0.0
        assert self.user_alpha >= 0.0
        assert self.no_components > 0
        assert self.k > 0
        assert self.n > 0
        assert 0 < self.rho < 1
        assert self.epsilon >= 0
        assert self.learning_schedule in SCHEDULES
        assert self.loss in LOSSES
        # The constructor rejects max_sampled < 1; a post-construction
        # mutation to 0 is the reference's documented no-op pass.
        if self.max_sampled < 0:
            raise ValueError("max_sampled must be non-negative")
        if self.fast_path not in ("auto", "on", "off"):
            raise ValueError("fast_path must be 'auto', 'on' or 'off'")
        if self.pool_kernels not in ("auto", "kernels", "einsum"):
            raise ValueError(
                "pool_kernels must be 'auto', 'kernels' or 'einsum'"
            )
        if self.fast_precision not in ("highest", "default"):
            raise ValueError("fast_precision must be 'highest' or 'default'")
        if self.shuffle_mode not in ("feistel", "sort"):
            raise ValueError("shuffle_mode must be 'feistel' or 'sort'")

    @property
    def adadelta(self) -> bool:
        return self.learning_schedule == "adadelta"
