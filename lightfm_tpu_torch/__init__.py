"""lightfm_tpu_torch: the PyTorch / CUDA port of lightfm_tpu.

It trains models (``fit``: every loss, schedule, L2 and feature layout
on one device, on the fast path through hand-written Hopper kernels where
it is eligible and on the plain-PyTorch generic path otherwise) and
serves them (``predict``, ``predict_rank`` and the evaluation metrics,
``recommend``) on an NVIDIA GPU; it imports neither ``jax`` nor
``lightfm_tpu``.  Over a ``torch.distributed`` mesh
(:mod:`lightfm_tpu_torch.parallel`) it trains data-parallel, with tables
replicated or split over the model axis by rows or by components, and
serves ``recommend`` with the catalog split over that axis.  Checkpoints
interchange with ``lightfm_tpu`` (:func:`save_model`, :func:`load_model`).

The host side comes with it: :mod:`lightfm_tpu_torch.data` (``Dataset``:
external ids to interaction, weight and feature matrices, on the native
ingest engine of :mod:`lightfm_tpu_torch.native`, built with ``g++`` at
first use), :mod:`lightfm_tpu_torch.cross_validation`
(``random_train_test_split``), :mod:`lightfm_tpu_torch.datasets` (the
MovieLens and StackExchange fetchers and ``generate_synthetic``) and
``observability.trace`` (a ``torch.profiler`` trace).
"""

from lightfm_tpu_torch.checkpoint import load_model, save_model
from lightfm_tpu_torch.model import LightFM
from lightfm_tpu_torch.version import __version__

__all__ = ["LightFM", "save_model", "load_model", "__version__"]
