"""rec_pangu_tpu_torch: the recommender framework on PyTorch and CUDA.

A port of ``rec_pangu_tpu`` (JAX on a TPU) to one NVIDIA H100.  It imports
nothing of JAX or of the JAX package: that package is the reference its
tests hold it against.  The JAX package's Pallas kernels become kernels
written by hand for Hopper (``ops/kernels``, sources in ``csrc``).

Ported so far: DeepFM ranking served end to end (data, encoders, metrics,
model, checkpoints in the JAX layout, ``RankTrainer``'s inference methods,
``make_ranking_scorer``).  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"

from .data import get_dataloader
from .models import get_model
from .train import RankTrainer

__all__ = ["get_dataloader", "get_model", "RankTrainer", "__version__"]
