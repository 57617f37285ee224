"""lightfm_tpu_torch: the PyTorch / CUDA port of lightfm_tpu.

It trains models on the fast path (``fit`` with WARP, BPR or logistic,
identity features, adagrad) and serves them (``predict``, ``predict_rank``
and the evaluation metrics, ``recommend``) on an NVIDIA GPU through
hand-written Hopper kernels; it imports neither ``jax`` nor
``lightfm_tpu``.  Other training configurations are not ported yet (see
ROADMAP.md): train them with ``lightfm_tpu`` and load the checkpoint with
:func:`load_model`.
"""

from lightfm_tpu_torch.checkpoint import load_model, save_model
from lightfm_tpu_torch.model import LightFM
from lightfm_tpu_torch.version import __version__

__all__ = ["LightFM", "save_model", "load_model", "__version__"]
