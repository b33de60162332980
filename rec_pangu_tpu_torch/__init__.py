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
``SequenceTrainer.fit``); then IOCRec, ContraRec and CLRec, the classic
sequence models, the ranking zoo, the multi-task zoo
(``RankTrainer(num_task=2)``), the session-graph family (SRGNN, GCSAN,
NISER), the multi-interest family (ComirecSA, ComirecDR, MIND, SINE, Re4,
CMI) and graph CF (NGCF, ``GeneralGraphDataset``, ``GraphTrainer``): all
39 models.  ``fit`` resumes from a checkpoint of either package, takes
``steps_per_call`` (one step a call for every K) and writes a profiler
trace; ``set_pretrained_weights``,
``BenchmarkTrainer``, wandb logging and ``utils`` (``seed_everything``,
``beautify_json``, ``get_device_usage``) are the JAX package's.
``serving.export_program`` writes a ranking model's scorer as a
``torch.export`` program whose lookup is the registered op
``rec_pangu_tpu_torch::embedding_lookup`` (importing this package registers
it; ``torch.export.load`` then reads the program), and ``ops`` has every
layer of the JAX package's, ``Dice`` and the ones no model builds
included.  ``parallel`` is the scale-out on ``torch.distributed``, one
process per device: ``make_mesh``, ``initialize_multihost``, the sharding
policy, ``distributed_topk``; ``RankTrainer.fit`` and ``GraphTrainer.fit``
take ``mesh`` (data-parallel, and row-sharded tables over ``model``), and
``get_recall_predict`` scores over it.  Not yet ported: the sequence
trainer's mesh (``SequenceTrainer.fit(mesh=...)``, ROADMAP Queue 1 item
12); by decision, ``export2tf`` (no TensorFlow exporter in torch) and
``utils/compile_cache.py``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
__version__ = "0.1.0"

from .data import get_dataloader
from .models import get_model
from .train import GraphTrainer, RankTrainer, SequenceTrainer

__all__ = ["get_dataloader", "get_model", "GraphTrainer", "RankTrainer", "SequenceTrainer",
           "__version__"]
