"""rec_pangu_tpu_torch: the recommender framework on PyTorch and CUDA.

A port of ``rec_pangu_tpu`` (JAX on a TPU) to one NVIDIA H100.  It imports
nothing of JAX or of the JAX package: that package is the reference its
tests hold it against.  The JAX package's Pallas kernels become kernels
written by hand for Hopper (``ops/kernels``, sources in ``csrc``).

Ported so far: DeepFM ranking served and trained end to end (data,
encoders, metrics, model, checkpoints in the JAX layout, ``RankTrainer``
with ``fit`` on the fused or the standard train step, ``make_ranking_scorer``);
SASRec retrieval served and evaluated (sequence datasets, the fused
transformer encoder, ``SequenceTrainer.evaluate_model``,
``make_retrieval_scorer``) and trained (the encoder's dropout forward and
backward kernels, the streamed full-softmax loss, the sequence fused step,
``SequenceTrainer.fit``).
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
__version__ = "0.1.0"

from .data import get_dataloader
from .models import get_model
from .train import RankTrainer, SequenceTrainer

__all__ = ["get_dataloader", "get_model", "RankTrainer", "SequenceTrainer", "__version__"]
