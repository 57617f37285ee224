"""Dataset fetchers and the synthetic generator (counterpart of
``lightfm_tpu/datasets``).  Nothing downloads at import."""

from lightfm_tpu_torch.datasets.movielens import fetch_movielens  # noqa: F401
from lightfm_tpu_torch.datasets.stackexchange import fetch_stackexchange  # noqa: F401
from lightfm_tpu_torch.datasets.synthetic import generate_synthetic  # noqa: F401
