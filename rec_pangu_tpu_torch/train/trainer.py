"""RankTrainer, SequenceTrainer and GraphTrainer: the JAX package's trainer
API on PyTorch.

RankTrainer's ``fit``, ``resume``, ``load_model``, ``save_model``,
``save_all``, ``save_train_model``, ``set_pretrained_weights``,
``evaluate_model``, ``predict_dataloader`` and ``predict_dataframe`` keep
the JAX package's names, signatures, checkpoint file names and metric
names.  The weights live in the model module itself: ``load_model`` copies
a checkpoint into it, and ``fit`` trains it where it stands, on the
trainer's device.

``fit`` takes the fused train step (``fused_update.py``: the table's Adam
update in one kernel pass) with Adam, as the JAX package does, and the
standard step (``steps.py``) when ``REC_PANGU_TPU_FUSED_ADAM=0`` or when
pretrained rows are pending (K3 would run Adam over the frozen rows).
Its options:

* ``resume_from``: the weights, batch statistics, step counter and
  optimizer state of a checkpoint of either package (``ckpt.read_opt_state``)
  replace the module's and the step's, on the step ``fit`` takes (the JAX
  ``fit`` falls back to its standard step and restarts the moments).  A
  state this reader does not know restores the weights only, with a
  warning, as in the JAX package.  The steps' dropout seeds then continue
  where the checkpoint's run stopped: ``fit``'s generator skips one seed
  for each restored step (``ops/dropout.skip_seeds``).
* ``steps_per_call=K`` is taken for the JAX package's signature, and every
  K runs one step a call: a step's only wait for the card is its upload's
  (``upload_batch`` waits for the queued work before its copies from
  pageable memory; the predictions stay on the card for the train
  metrics, the loss is read only when it is logged), and K batches
  stacked into one pinned copy ran slower on the card
  (``scripts/torch_k_steps.py``).  The counterpart of JAX's one dispatch
  for K steps would be a CUDA graph.
* ``profile_dir``: ``torch.profiler`` (CPU, and CUDA on the card) over the
  first epoch, its Chrome trace written there (``trace_path``).  Beside
  torch's ops and kernels the trace holds the port's spans
  (``utils/trace.py``): ``train.step`` a step, with ``batch.upload``,
  ``batch.check`` and ``batch.wait`` in it, and in a fused step
  ``step.forward``, ``step.backward``, ``table.update`` and
  ``table.sort``, and the streamed CE's ``ce.forward``, ``ce.backward``
  and ``ce.product``.
* ``mesh``: a mesh from ``parallel.make_mesh``; every rank calls ``fit``
  with the same loaders.  ``fit`` shards the model in place
  (``parallel/sharding.shard_state``: the tables row-sharded over
  ``model``), and each rank trains on its contiguous row block of every
  batch (a batch that does not divide ``data`` runs whole on every rank,
  as the JAX package places it replicated), or on the batches of a loader
  built with ``shard_rank=<data rank>, num_shards=<n_data>`` as they come.
  The fused step runs when the ``model`` axis is 1 (the cotangent rows
  gathered over ``data``, K3 on every replica), else the standard step
  (the sharded lookup, each block's gradient all-reduced over ``data``).
  The step's outputs are the global batch's (predictions gathered, the
  loss the global mean), so every rank logs the same metrics;
  ``evaluate_model`` and ``predict_dataloader`` then run under the same
  mesh, each rank predicting its block; only global rank 0 writes the
  checkpoints, the whole tables gathered first, in the JAX layout.

A kept difference from the JAX ``fit``: it trains the module's weights as
they are (the PyTorch idiom: the module owns its weights, made by its
constructor's ``seed``, and ``resume_from`` overwrites them), where the
JAX ``fit`` initializes new ones from ``seed``; here ``seed`` seeds the
generator the steps draw each step's dropout seed from.

SequenceTrainer drives sequence-recall models: ``load_model``, the
``save_*`` methods, ``evaluate_model`` (top-200 retrieval over the whole
corpus, then recall/ndcg/hitrate at each k, as in the JAX package) and
``fit``: per epoch the train steps (the sequence fused step with Adam from a
fresh state, or the standard step with ``REC_PANGU_TPU_FUSED_ADAM=0`` or
pending pretrained rows), then ``evaluate_model`` on the valid loader, a
row of ``log.csv``, the ``model_e_{i}`` checkpoint and early stopping.
``seed`` seeds the generator the steps draw their dropout seeds (and
sampled negatives) from; ``steps_per_call`` is RankTrainer's.  A model with
``renorm_param_paths`` (CMI) trains projected:
those rows are put back on the unit sphere at the start of ``fit`` and
after every step.  ``mesh`` is RankTrainer's: ``fit`` shards the model (the
item tables row-sharded over ``model``), and each rank runs its block of
every batch.  The host keys (the views, CMI's negatives, ``lookup_all``,
the session graph) are drawn from the whole batch on every rank, the same
draws as the single device's, and then cut to the rank's rows (each view's
block of ``aug_all``; under a loader sharded over the data ranks, the views
and negatives are drawn for the ranks' batches gathered in rank order and
each rank keeps its rows).  Under a ``model`` axis of 1 the sequence
fused step runs on the block (``fused_update.SeqFusedStep``); under a
``model`` axis the standard step, the lookups and the softmax CE on the
rank's rows of the table.  ``evaluate_model`` ranks through the
distributed top-k over the mesh, and checkpoints hold the whole tables,
written by global rank 0.

GraphTrainer drives graph CF (NGCF): ``fit`` samples a BPR batch a step
from the dataset and takes the standard step; ``evaluate_model`` scores
every test user against the whole item table in chunks of 1,024 users on
the model's device, sets each user's train items to -inf and takes the
top min(1000, items) (``masked_topk``), then recall/ndcg/hitrate at
``topN``.  Under a mesh (``fit(mesh=...)``) each rank takes its block of
every BPR batch while the graph and its products stay whole on every rank,
and ``evaluate_model`` ranks through ``distributed_masked_topk`` over the
item table split across ``model``.

Both RankTrainer and SequenceTrainer take ``wandb_config``: with the
``wandb`` package installed, ``fit`` logs in and starts a run with it,
logs ``{"loss": ...}`` every ``log_rounds`` batches and each epoch's
metrics (``utils/logging.py``'s stand-in does nothing otherwise).

``device=None`` means the CUDA card (see ``utils/device.py``); a method's
``device`` argument, when given, overrides the trainer's.
"""
from __future__ import annotations

import csv
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..convert import load_jax_variables
from ..data.loader import DataLoader
from ..eval.metrics import RollingMetricBuffer, compute_ranking_metrics
from ..eval.retrieval import evaluate_recall, get_recall_predict
from ..models.pretrained import inject_pretrained
from ..models.sequence.augment import host_augment_sequences
from ..ops.dropout import skip_seeds
from ..ops.graph import attach_session_graph
from ..parallel.comm import gather_rows, mean_over
from ..parallel.sharding import (shard_frozen, shard_opt_state, shard_state,
                                 shard_variables, whole_opt_state, whole_variables)
from ..parallel.topk import distributed_masked_topk, pad_to_multiple
from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import HAS_WANDB, logger, wandb
from ..utils import trace
from .ckpt import load_checkpoint, read_opt_state, save_checkpoint
from .fused_update import maybe_enable_fused_update, maybe_enable_seq_fused_update
from .steps import StandardStep, make_param_renorm, strip_host_keys

def _check_mesh(mesh) -> None:
    """A mesh argument must be ``parallel.make_mesh``'s (a DeviceMesh)."""
    if mesh is not None and not hasattr(mesh, "get_group"):
        raise TypeError(f"mesh must be a DeviceMesh from parallel.make_mesh, got "
                        f"{type(mesh).__name__}")


def _view_rows(v, views: int, lo: int, b: int):
    """Rows ``lo .. lo + b`` of each of the ``views`` views stacked in ``v``
    ([view 0; view 1; ...]), stacked in the same order."""
    if views == 1:
        return v[lo:lo + b]
    v = np.asarray(v)
    return v.reshape(views, -1, *v.shape[1:])[:, lo:lo + b].reshape(views * b, *v.shape[1:])


class _BaseTrainer:
    """Checkpoints, the device, resume, pretrained rows, wandb and the
    train steps' calls, shared by the trainers."""

    #: batch keys that stack several views of the batch's rows, and how many
    _STACKED_VIEWS: Dict[str, int] = {}

    def __init__(self, model_ckpt_dir: str = "./model_ckpt", device: DeviceLike = None,
                 wandb_config: Optional[dict] = None):
        self.model_ckpt_dir = model_ckpt_dir
        self.device = resolve_device(device)
        self.wandb_config = wandb_config
        self.use_wandb = wandb_config is not None and HAS_WANDB
        self.step = 0  # optimizer steps taken; carried from a loaded checkpoint
        self.model = None
        self._train_step = None  # StandardStep or FusedStep, built by fit
        self._renorm = None      # the projection after each step (SequenceTrainer.fit)
        self._aug_rng = None     # the host augmentations' and negatives' generator
        self._pending_pretrained: List[Tuple[str, dict, bool]] = []
        self.trace_path: Optional[str] = None  # fit(profile_dir=...)'s trace
        self.mesh = None         # fit's mesh
        self._presplit = False   # fit's loader gives each rank its own rows

    def _device(self, device: DeviceLike) -> torch.device:
        return self.device if device is None else resolve_device(device)

    def set_pretrained_weights(self, model, col_name: str, pretrained_dict: dict,
                               trainable: bool = True) -> None:
        """Queue pretrained rows for ``col_name``, written into the model's
        fused tables when ``fit`` starts; ``trainable=False`` keeps them as
        written through training."""
        self._pending_pretrained.append((col_name, pretrained_dict, trainable))
        logger.info(f"Queued pretrained embedding for column:{col_name} "
                    f"With Trainable={trainable}")

    def _inject_pretrained(self, model) -> List[Tuple[torch.Tensor, slice]]:
        """Write the queued rows; returns the frozen (table, rows) pairs."""
        frozen = []
        for col_name, pre_dict, trainable in self._pending_pretrained:
            touched = inject_pretrained(model, model.enc_dict, col_name, pre_dict,
                                        model.embedding_dim)
            if not trainable:
                frozen.extend(touched)
            logger.info(f"Set pretrained embedding weights for column:{col_name}")
        return frozen

    def _wandb_init(self) -> None:
        """Log in with the config's ``key`` (popped), then start a run with
        the rest of it."""
        cfg = dict(self.wandb_config)
        key = cfg.pop("key", None)
        if key:
            wandb.login(key=key)
        wandb.init(**cfg)

    def _start_fit(self, model, device: DeviceLike, mesh=None) -> torch.device:
        dev = self._device(device)
        if mesh is not None and mesh.device_type != dev.type:
            raise ValueError(f"the mesh lies on {mesh.device_type}, the trainer trains on "
                             f"{dev}")
        os.makedirs(self.model_ckpt_dir, exist_ok=True)
        self.model = model.to(dev)
        self._fit_device = dev
        self.step = 0
        return dev

    def _shard(self, model, mesh, frozen=(), loader=None):
        """Shard ``model`` over ``mesh`` (once: a model already sharded over
        it is kept as it is) and translate the frozen rows to the rank's
        blocks; note whether ``loader`` gives each rank its own rows.
        Returns the frozen pairs."""
        self.mesh, self._presplit = mesh, False
        state = getattr(model, "mesh_state", None)
        if mesh is None:
            if state is not None:
                raise ValueError("the model is sharded over a mesh: pass that mesh to fit")
            return list(frozen)
        if state is None:
            whole = {id(t): "/".join(p) for _, p, t, _ in model.jax_leaves()}
            state = shard_state(model, mesh)
            frozen = shard_frozen(model, list(frozen), whole)
        elif state.mesh is not mesh:
            raise ValueError("the model is sharded over another mesh")
        shards = int(getattr(loader, "num_shards", 1))
        if shards > 1:
            if shards != state.n_data or loader.shard_rank != state.data_rank:
                raise ValueError(f"a sharded loader under a ({state.n_data}, {state.n_model}) "
                                 f"mesh needs num_shards={state.n_data} and shard_rank=<data "
                                 f"rank {state.data_rank}>, got {shards} and "
                                 f"{loader.shard_rank}")
            if len(loader.dataset) % shards:
                raise ValueError(f"{len(loader.dataset)} rows do not split evenly over "
                                 f"{shards} loader shards: the ranks' batches must match")
            self._presplit = True
        return list(frozen)

    def _is_writer(self, model) -> bool:
        state = getattr(model, "mesh_state", None)
        return state is None or state.is_writer

    # ------------------------------------------------------------- ckpt api
    def load_model(self, model, path: str) -> dict:
        """Load a checkpoint (the JAX package's layout) into ``model``, move
        it to the trainer's device in eval mode, and return the checkpoint."""
        ckpt = load_checkpoint(path)
        load_jax_variables(model, shard_variables(model, {"params": ckpt["params"],
                                                          "batch_stats": ckpt.get("batch_stats")}))
        model.to(self.device).eval()
        self.step = int(ckpt.get("step", 0))
        return ckpt

    def resume(self, path: str) -> dict:
        """Restore the weights, batch statistics, step counter and optimizer
        state of the checkpoint at ``path`` into the model and the step
        ``fit`` built; an optimizer state this port cannot read restores
        the weights only, with a warning.  On a sharded model each rank reads
        its blocks of the whole tables and their moments."""
        ckpt = load_checkpoint(path)
        load_jax_variables(self.model, shard_variables(
            self.model, {"params": ckpt["params"], "batch_stats": ckpt.get("batch_stats")}))
        self.step = int(ckpt.get("step", 0))
        state = read_opt_state(ckpt.get("opt_state"), self.step)
        if state is not None:
            self._train_step.load_opt_state(shard_opt_state(self.model, state))
        elif ckpt.get("opt_state") is not None:
            logger.warning("Checkpoint optimizer state is of an unknown structure: restoring "
                           "params only; optimizer restarts from scratch")
        logger.info(f"Resumed from {path} at step {self.step}")
        return ckpt

    def _write(self, path: str, model, with_opt: bool, enc_dict: Optional[dict] = None) -> None:
        """One checkpoint in the JAX layout.  On a sharded model every rank
        gathers the whole tables and moments, global rank 0 writes, and the
        others wait for it at a barrier."""
        variables = whole_variables(model)
        opt_state = whole_opt_state(model, self._opt_state()) if with_opt else None
        if self._is_writer(model):
            save_checkpoint(path, **variables, opt_state=opt_state, enc_dict=enc_dict,
                            step=self.step)
        if getattr(model, "mesh_state", None) is not None:
            torch.distributed.barrier()

    def _opt_state(self):
        return None if self._train_step is None else self._train_step.opt_state(self.step)

    def save_model(self, model, model_ckpt_dir: str) -> str:
        """Weights-only checkpoint ``model.ckpt``, readable by both packages."""
        path = os.path.join(model_ckpt_dir, "model.ckpt")
        self._write(path, model, with_opt=False)
        return path

    def save_all(self, model, enc_dict: dict, model_ckpt_dir: str) -> str:
        """Weights, optimizer state and enc_dict in ``model.ckpt``."""
        path = os.path.join(model_ckpt_dir, "model.ckpt")
        self._write(path, model, with_opt=True, enc_dict=enc_dict)
        logger.info(f"Model+enc_dict saved to {path}")
        return path

    def save_train_model(self, model, model_ckpt_dir: str, model_str: str) -> str:
        """Per-epoch checkpoint ``model_{model_str}.ckpt`` with optimizer state."""
        path = os.path.join(model_ckpt_dir, f"model_{model_str}.ckpt")
        self._write(path, model, with_opt=True)
        return path

    # ----------------------------------------------------------------- steps
    def _host_inputs(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The host batch a training step uploads (the sequence trainer adds
        its host keys)."""
        return batch

    def _step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One train step on a host batch: the host keys, id check, upload,
        the step, the projection.  Under a mesh the step runs on the rank's
        block (``_block``) and its outputs are the global batch's
        (``_global``)."""
        state = getattr(self.model, "mesh_state", None)
        if state is None:
            return self._step_on(batch)
        block, split, first = self._block(batch, state, self._presplit)
        rows = self._rows(block)
        with state.running(split, first, rows * state.n_data if split else rows):
            out = self._step_on(block)
        out = self._global(out, state, split, rows)
        if self._presplit and "label" in block:  # the ranks' labels, in the predictions' order
            out["label"] = gather_rows(torch.as_tensor(
                np.asarray(block["label"], np.float32), device=self._fit_device),
                state.data_group)
        return out

    def _step_on(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        with trace.span("train.step", self.step, self._fit_device):
            out = self._train_step(self.model.upload_batch(self._host_inputs(batch),
                                                           self._fit_device, train=True),
                                   self.step)
            if self._renorm is not None:
                self._renorm()
        self.step += 1
        return out

    @staticmethod
    def _rows(batch: Dict[str, np.ndarray]) -> int:
        return len(next(iter(batch.values())))

    @classmethod
    def _block(cls, batch: Dict[str, np.ndarray], state, presplit: bool = False):
        """(the rank's rows, split, their first global row) of a host batch:
        the contiguous block of a batch that divides ``data`` (or the batch
        itself when the loader already gave the rank its own rows), else
        the whole batch, which every rank runs.  A key of
        ``_STACKED_VIEWS`` stacks its block's rows of each view."""
        rows = cls._rows(batch)
        if presplit and state.n_data > 1:
            return batch, True, state.data_rank * rows
        if not state.splits(rows):
            return batch, False, 0
        b = rows // state.n_data
        lo = state.data_rank * b
        return ({k: _view_rows(v, cls._STACKED_VIEWS.get(k, 1), lo, b) for k, v in batch.items()},
                True, lo)

    @staticmethod
    def _global(out: Dict[str, torch.Tensor], state, split: bool,
                rows: int) -> Dict[str, torch.Tensor]:
        """A block step's outputs as the global batch's: the loss the mean
        of the blocks' losses, every output of the block's rows gathered
        over ``data`` in rank order."""
        if not split:
            return out
        glob = {}
        for k, v in out.items():
            if k == "loss":
                glob[k] = mean_over(v, state.data_group)
            elif torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == rows:
                glob[k] = gather_rows(v.detach(), state.data_group)
            else:
                glob[k] = v
        return glob

    def _steps(self, train_loader) -> Iterator[Tuple[dict, Dict[str, torch.Tensor]]]:
        """(host batch, step outputs) of each step over ``train_loader``."""
        for batch in train_loader:
            batch, _ = strip_host_keys(batch)
            yield batch, self._step(batch)

    def _log_iter(self, idx: int, out, max_iter: int, start: float, log_rounds: int) -> None:
        """The log line (and wandb's ``{"loss"}``) every ``log_rounds`` steps."""
        if idx % log_rounds != 0:
            return
        loss = float(out["loss"].detach())
        elapsed = time.time() - start
        remaining = round(((elapsed / (idx + 1)) * (max_iter - idx + 1)) / 60, 2)
        logger.info(f"Iter {idx}/{max_iter} Remaining time:{remaining} min "
                    f"Loss:{round(loss, 4)}")
        if self.use_wandb:
            wandb.log({"loss": loss})


class RankTrainer(_BaseTrainer):
    def __init__(self, num_task: int = 1, model_ckpt_dir: str = "./model_ckpt",
                 device: DeviceLike = None, wandb_config: Optional[dict] = None):
        super().__init__(model_ckpt_dir, device, wandb_config)
        self.num_task = num_task

    # ----------------------------------------------------------------- train
    def fit(self, model, train_loader: DataLoader, valid_loader: Optional[DataLoader] = None,
            epoch: int = 10, lr: float = 1e-3, device: DeviceLike = None,
            use_earlystopping: bool = False, max_patience: int = 999,
            monitor_metric: Optional[str] = None, lr_scheduler_type: str = "",
            scheduler_params: Optional[dict] = None, seed: int = 1029,
            log_rounds: int = 100, mesh=None, resume_from: Optional[str] = None,
            profile_dir: Optional[str] = None, steps_per_call: int = 1) -> Dict[str, float]:
        _check_mesh(mesh)
        dev = self._start_fit(model, device, mesh)
        frozen = self._shard(model, mesh, self._inject_pretrained(model), train_loader)
        if self.use_wandb and self._is_writer(model):
            self._wandb_init()
        generator = torch.Generator().manual_seed(seed)
        steps_per_epoch = len(train_loader)
        self._train_step = None
        if not self._pending_pretrained:
            self._train_step = maybe_enable_fused_update(
                model, lr, steps_per_epoch, lr_scheduler_type, scheduler_params, generator)
        if self._train_step is not None:
            logger.info("Embedding Adam update fused into the table kernel")
        else:
            self._train_step = StandardStep(model, lr, steps_per_epoch, lr_scheduler_type,
                                            scheduler_params, generator, frozen)
        if resume_from:
            self.resume(resume_from)
            skip_seeds(generator, self.step)
        self._profile_dir = profile_dir
        n_params = sum(p.numel() for p in model.parameters())
        logger.info(f"Model initialized: {n_params:,} parameters")

        logger.info("Model Starting Training")
        best_epoch, best_metric = -1, -np.inf
        train_metric: Dict[str, float] = {}
        for i in range(1, epoch + 1):
            train_metric = self._train_one_epoch(train_loader, i, log_rounds)
            logger.info(f"Epoch {i} Train Metric:{train_metric}")
            if self.use_wandb and self._is_writer(model):
                wandb.log(train_metric)
            if valid_loader is not None:
                valid_metric = self.evaluate_model(self.model, valid_loader, dev)
                self.save_train_model(self.model, self.model_ckpt_dir, f"e_{i}")
                if self.use_wandb and self._is_writer(model):
                    wandb.log(valid_metric)
                if use_earlystopping:
                    if monitor_metric not in valid_metric:
                        raise KeyError(f"{monitor_metric} not in Valid Metric "
                                       f"{valid_metric.keys()}")
                    if valid_metric[monitor_metric] > best_metric:
                        best_epoch = i
                        best_metric = valid_metric[monitor_metric]
                        self.save_train_model(self.model, self.model_ckpt_dir, "best")
                    if i - best_epoch >= max_patience:
                        logger.info(f"EarlyStopping at the Epoch {i} Valid Metric:{valid_metric}")
                        break
                logger.info(f"Epoch {i} Valid Metric:{valid_metric}")
        return train_metric

    def _start_profile(self):
        """torch.profiler over the first epoch: CPU activities, and CUDA's on
        the card."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self._fit_device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        trace.reset()
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        if self._fit_device.type == "cuda":
            torch.cuda.synchronize(self._fit_device)
        prof.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        self.trace_path = os.path.join(self._profile_dir, f"trace_{os.getpid()}_"
                                                          f"{time.time_ns()}.json")
        prof.export_chrome_trace(self.trace_path)
        logger.info(f"Profiler trace written to {self.trace_path}")

    def _train_one_epoch(self, train_loader, epoch_idx: int = 1, log_rounds: int = 100):
        prof = (self._start_profile() if getattr(self, "_profile_dir", None) and epoch_idx == 1
                else None)
        # bounded train-metric accumulation: constant host memory per epoch
        window = int(os.environ.get("REC_PANGU_TPU_TRAIN_METRIC_WINDOW", str(1 << 20)))
        preds = RollingMetricBuffer(window)
        labels = RollingMetricBuffer(window)
        max_iter = len(train_loader)
        self.model.train()
        start = time.time()
        for idx, (batch, out) in enumerate(self._steps(train_loader)):
            if self.num_task == 1:
                pred = out["pred"]
            else:
                pred = torch.cat([out[f"task{t + 1}_pred"].reshape(-1, 1)
                                  for t in range(self.num_task)], dim=1)
            preds.append(pred.detach())  # stays on the device until the epoch ends
            label = out.get("label", batch["label"])  # a sharded loader's step: all ranks' labels
            labels.append(label)
            self._log_iter(idx, out, max_iter, start, log_rounds)
        if prof is not None:
            self._stop_profile(prof)
        pred_arr = preds.concat()
        label_arr = labels.concat()
        return compute_ranking_metrics(label_arr, pred_arr, prefix="train_",
                                       num_task=self.num_task)

    # ------------------------------------------------------------- inference
    def _predict(self, model, batch, device: torch.device) -> np.ndarray:
        """[B, num_task] predictions of one host batch; on a sharded model
        each rank predicts its block and every rank gets the whole batch's."""
        state = getattr(model, "mesh_state", None)
        if state is None:
            return self._predict_rows(model, batch, device).cpu().numpy()
        block, split, first = self._block(batch, state)
        with state.running(split, first):
            pred = self._predict_rows(model, block, device)
        return (gather_rows(pred, state.data_group) if split else pred).cpu().numpy()

    def _predict_rows(self, model, batch, device: torch.device) -> torch.Tensor:
        inputs = model.upload_batch(batch, device)
        with torch.inference_mode():
            out = model(inputs, train=False)
        if self.num_task == 1:
            return out["pred"].reshape(-1, 1)
        return torch.cat([out[f"task{t + 1}_pred"].reshape(-1, 1)
                          for t in range(self.num_task)], dim=1)

    @staticmethod
    def _check_eval_loader(model, loader) -> None:
        if (getattr(model, "mesh_state", None) is not None
                and int(getattr(loader, "num_shards", 1)) > 1):
            raise ValueError("under a mesh, evaluation reads every row on every rank: pass an "
                             "unsharded loader (each rank predicts its block of each batch)")

    def evaluate_model(self, model, test_loader: DataLoader,
                       device: DeviceLike = None) -> Dict[str, float]:
        """'roc_auc_score'/'log_loss' for one task, 'test_task{i}_*' for
        several; under a mesh the same on every rank."""
        self._check_eval_loader(model, test_loader)
        dev = self._device(device)
        model.to(dev).eval()
        preds, labels = [], []
        for batch in test_loader:
            preds.append(self._predict(model, batch, dev))
            labels.append(np.asarray(batch["label"]).reshape(len(batch["label"]), -1))
        prefix = "" if self.num_task == 1 else "test_"
        return compute_ranking_metrics(np.concatenate(labels), np.concatenate(preds),
                                       prefix=prefix, num_task=self.num_task)

    def predict_dataloader(self, model, test_loader: DataLoader,
                           device: DeviceLike = None) -> np.ndarray:
        self._check_eval_loader(model, test_loader)
        dev = self._device(device)
        model.to(dev).eval()
        preds = [self._predict(model, batch, dev) for batch in test_loader]
        out = np.concatenate(preds)
        return out.reshape(-1) if self.num_task == 1 else out

    def predict_dataframe(self, model, test_df, enc_dict: dict, schema: dict,
                          batch_size: int = 1024, device: DeviceLike = None) -> np.ndarray:
        """Encode a raw df with the saved enc_dict and predict it."""
        from ..data.dataset import MultiTaskDataset
        from ..data.process_data import get_single_dataloader

        if self.num_task > 1 and not isinstance(schema.get("label_col"), list):
            loader = DataLoader(MultiTaskDataset(schema, test_df, enc_dict=enc_dict),
                                batch_size=batch_size, shuffle=False)
        else:
            loader = get_single_dataloader(test_df, schema, enc_dict, batch_size)
        return self.predict_dataloader(model, loader, device)


def _write_log_csv(path: str, rows: List[Dict[str, float]]) -> None:
    """One row an epoch: the epoch, then the valid metrics (the JAX trainer
    writes the same columns with pandas)."""
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


class SequenceTrainer(_BaseTrainer):
    """Sequence-recall models: training, checkpoints, evaluation."""

    _STACKED_VIEWS = {"aug_all": 3}  # [hist; aug1; aug2]

    def fit(self, model, train_loader: DataLoader, valid_loader: Optional[DataLoader] = None,
            epoch: int = 50, lr: float = 1e-3, device: DeviceLike = None,
            use_earlystopping: bool = False, max_patience: int = 999,
            monitor_metric: Optional[str] = None, log_rounds: int = 100,
            topk_list: Optional[List[int]] = None, lr_scheduler_type: str = "",
            scheduler_params: Optional[dict] = None, seed: int = 1029, mesh=None,
            steps_per_call: int = 1) -> None:
        _check_mesh(mesh)
        topk_list = topk_list or [20, 50, 100]
        dev = self._start_fit(model, device, mesh)
        frozen = self._shard(model, mesh, self._inject_pretrained(model), train_loader)
        writer = self._is_writer(model)
        if self.use_wandb and writer:
            self._wandb_init()
        generator = torch.Generator().manual_seed(seed)
        steps_per_epoch = len(train_loader)
        self._train_step = None
        if not self._pending_pretrained:  # K3's whole-table pass would move frozen rows
            self._train_step = maybe_enable_seq_fused_update(
                model, lr, steps_per_epoch, lr_scheduler_type, scheduler_params,
                generator=generator)
        if self._train_step is not None:
            logger.info("Item-table Adam update fused into the table kernel "
                        "(history + softmax-CE gradients)")
        else:
            self._train_step = StandardStep(model, lr, steps_per_epoch, lr_scheduler_type,
                                            scheduler_params, generator, frozen)
        paths = tuple(getattr(model, "renorm_param_paths", ()) or ())
        self._renorm = make_param_renorm(model, paths) if paths else None
        if self._renorm is not None:  # the reference's first forward normalizes the init
            self._renorm()
        logger.info("Model Starting Training")
        log_rows: List[Dict[str, float]] = []
        best_epoch, best_metric = -1, -np.inf
        for i in range(1, epoch + 1):
            self.model.train()
            start = time.time()
            for idx, (_, out) in enumerate(self._steps(train_loader)):
                self._log_iter(idx, out, steps_per_epoch, start, log_rounds)
            if valid_loader is None:
                continue
            valid_metric = self.evaluate_model(self.model, valid_loader, dev,
                                               topk_list=topk_list)
            logger.info(f"Epoch {i} Valid Metric:{valid_metric}")
            if self.use_wandb and writer:
                wandb.log(valid_metric)
            log_rows.append({"epoch": i, **valid_metric})
            if writer:
                _write_log_csv(os.path.join(self.model_ckpt_dir, "log.csv"), log_rows)
            self.save_train_model(self.model, self.model_ckpt_dir, f"e_{i}")
            if use_earlystopping:
                if monitor_metric not in valid_metric:
                    raise KeyError(f"{monitor_metric} not in Valid Metric {valid_metric.keys()}")
                if valid_metric[monitor_metric] > best_metric:
                    best_epoch = i
                    best_metric = valid_metric[monitor_metric]
                    self.save_train_model(self.model, self.model_ckpt_dir, "best")
                if i - best_epoch >= max_patience:
                    logger.info(f"EarlyStopping at the Epoch {i} Valid Metric:{valid_metric}")
                    break

    def _host_inputs(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if getattr(self.model, "mesh_state", None) is not None:
            return batch  # ``_step`` drew the keys from the whole batch
        return self._attach_host_keys(batch)

    def _step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Under a mesh the host keys are drawn from the whole batch first
        (from a sharded loader's, the data ranks' batches gathered in rank
        order), then cut to the rank's block with the rest (``_block``)."""
        state = getattr(self.model, "mesh_state", None)
        if state is not None:
            batch = self._attach_host_keys(batch, state if self._presplit else None)
        return super()._step(batch)

    @staticmethod
    def _rows(batch: Dict[str, np.ndarray]) -> int:
        return len(batch["hist_item_list"])

    def _attach_host_keys(self, batch: Dict[str, np.ndarray],
                          presplit=None) -> Dict[str, np.ndarray]:
        """The training batch with the keys the model's one table lookup
        reads, made on the host as the JAX trainer makes them:

        * a ``host_aug`` model (IOCRec, ContraRec): ``aug_all`` = [hist; aug1;
          aug2] [3B, L], the two views drawn from the trainer's
          ``np.random.default_rng(10_301)``;
        * a ``host_negatives`` model (CMI): ``neg_items`` [B] int32 uniform
          in [1, max(vocab - 1, 2)), drawn from the same generator;
        * a model with ``lookup_extra`` (CLRec: the target item; CMI: the
          target and the negative), when the batch holds every extra:
          ``lookup_all`` = [hist | extras] [B, L + extras] int32;
        * a ``session_graph`` model (the SRGNN family): the host session
          graph's ``graph_nodes`` and ``graph_alias`` [B, L] int32
          (``ops/graph.attach_session_graph``).

        Keys the batch already holds are kept.  ``presplit``, the mesh state
        of a fit whose loader gives each data rank its own rows: the views
        and negatives are drawn for the data ranks' batches gathered in rank
        order, every rank from the same generator, and each rank keeps its
        rows of them."""
        model = self.model
        hist = np.asarray(batch["hist_item_list"])
        aug = getattr(model, "host_aug", False) and "aug_all" not in batch
        neg = getattr(model, "host_negatives", False) and "neg_items" not in batch
        if aug or neg:
            whole, mine = hist, slice(0, len(hist))
            if presplit is not None:
                whole = gather_rows(torch.as_tensor(hist, device=self._fit_device),
                                    presplit.data_group).cpu().numpy()
                mine = slice(presplit.data_rank * len(hist), (presplit.data_rank + 1) * len(hist))
            if self._aug_rng is None:
                self._aug_rng = np.random.default_rng(10_301)
        if aug:
            views = [host_augment_sequences(self._aug_rng, whole, model.beta_a, model.beta_b,
                                            model.mask_token)[mine] for _ in range(2)]
            batch = {**batch, "aug_all": np.concatenate([hist] + views, axis=0)}
        if neg:
            high = max(model.item_emb.vocab_size - 1, 2)
            batch = {**batch, "neg_items": self._aug_rng.integers(1, high, len(whole))[mine]
                     .astype(np.int32)}
        extras = getattr(model, "lookup_extra", ())
        if extras and "lookup_all" not in batch and all(k in batch for k in extras):
            parts = [hist.reshape(hist.shape[0], -1)]
            parts += [np.asarray(batch[k]).reshape(hist.shape[0], -1) for k in extras]
            batch = {**batch, "lookup_all": np.concatenate(parts, axis=1).astype(np.int32)}
        if getattr(model, "session_graph", False):
            batch = attach_session_graph(batch)
        return batch

    def evaluate_model(self, model, test_loader: DataLoader, device: DeviceLike = None,
                       topk_list: Optional[List[int]] = None,
                       approx_recall_target: Optional[float] = None) -> Dict[str, float]:
        """Top-200 retrieval for every user of ``test_loader`` (a sequence
        loader of the valid or test phase), then 'recall@k', 'ndcg@k' and
        'hitrate@k' for each k of ``topk_list`` (20, 50, 100 by default),
        rounded to 4 dp.  ``approx_recall_target`` is answered exactly.  On a
        model sharded over a mesh every rank runs every batch and ranks
        through the distributed top-k over its rows (the JAX trainer passes
        its mesh to ``get_recall_predict`` too); every rank gets the same
        metrics."""
        topk_list = topk_list or [20, 50, 100]
        model.to(self._device(device)).eval()
        test_gd = test_loader.dataset.get_test_gd()
        state = getattr(model, "mesh_state", None)
        preds = get_recall_predict(model, test_loader, topn=200,
                                   mesh=None if state is None else state.mesh,
                                   approx_recall_target=approx_recall_target)
        metric_dict: Dict[str, float] = {}
        for k in topk_list:
            res = evaluate_recall(preds, test_gd, k)
            logger.info(res)
            metric_dict.update(res)
        return metric_dict


def masked_topk(user_embs: torch.Tensor, item_embs: torch.Tensor, users: torch.Tensor,
                seen: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k item ids [B, k] of ``users`` [B] scored against every item,
    each user's ``seen`` [B, S] items (padded with the item count) set to
    -inf first: a sentinel column past the last item takes the pads."""
    scores = torch.matmul(user_embs[users], item_embs.t())
    scores = torch.nn.functional.pad(scores, (0, 1))
    scores.scatter_(1, seen, float("-inf"))
    return torch.topk(scores[:, :-1], k, dim=1).indices


class GraphTrainer(_BaseTrainer):
    """Graph CF (NGCF): BPR steps, full-corpus top-k eval with each user's
    train items filtered out."""

    EVAL_CHUNK = 1024   # users scored at once

    def __init__(self, model_ckpt_dir: str = "./model_ckpt", device: DeviceLike = None):
        super().__init__(model_ckpt_dir, device)

    def fit(self, model, train_dataset, epoch: int = 10, lr: float = 1e-3,
            device: DeviceLike = None, batch_size: int = 1024, seed: int = 1029,
            mesh=None) -> None:
        """``epoch`` epochs of ``len(train_dataset) // batch_size`` (at
        least 1) standard steps, each on a fresh ``sample(batch_size)``
        (under a mesh every rank draws the same batch and trains on its
        block of it)."""
        _check_mesh(mesh)
        self._start_fit(model, device, mesh)
        self._shard(model, mesh)
        steps_per_epoch = max(1, len(train_dataset) // batch_size)
        generator = torch.Generator().manual_seed(seed)
        self._train_step = StandardStep(model, lr, steps_per_epoch, generator=generator,
                                        global_rows=False)
        model.train()
        for i in range(1, epoch + 1):
            losses = [self._step(train_dataset.sample(batch_size))["loss"].detach()
                      for _ in range(steps_per_epoch)]
            logger.info(f"Epoch {i} Loss:{round(float(torch.stack(losses).sum()), 4)}")

    def evaluate_model(self, model, train_dataset, test_dataset,
                       hidden_size: Optional[int] = None, topN: int = 50) -> Dict[str, float]:
        """recall, ndcg and hit rate at ``topN`` of every user of
        ``test_dataset``, on the model's device: ``masked_topk`` over chunks
        of ``EVAL_CHUNK`` users with k = min(1000, items), each user's
        ``train_dataset`` items filtered out before the top-k (the same
        unseen items in the same order as the reference's filter after a
        top-1000).  Only the first ``topN`` of each list leave the device.
        Under a mesh (the model's ``mesh_state``) every rank scores every
        user against its rows of the item table, padded to a multiple of the
        ``model`` axis (``distributed_masked_topk``), and gets the same
        metrics."""
        dev = next(model.parameters()).device
        state = getattr(model, "mesh_state", None)
        model.eval()
        with torch.inference_mode():
            out = model({}, train=False)
            user_embs, item_embs = out["user_emb"], out["item_emb"]
            train_gd, test_gd = train_dataset.test_gd, test_dataset.test_gd
            users = np.fromiter(test_gd.keys(), dtype=np.int64)
            n_items = int(item_embs.shape[0])
            k = min(1000, n_items)
            if state is not None:
                items_p = pad_to_multiple(item_embs, state.n_model)
            max_seen = max([len(train_gd.get(int(u), [])) for u in users] or [0])
            seen = np.full((len(users), max(1, max_seen)), n_items, dtype=np.int64)
            for i, u in enumerate(users):
                items = train_gd.get(int(u), [])
                seen[i, :len(items)] = items
            tops = []
            for s in range(0, len(users), self.EVAL_CHUNK):
                chunk = slice(s, s + self.EVAL_CHUNK)
                chunk_users = torch.from_numpy(users[chunk]).to(dev)
                chunk_seen = torch.from_numpy(seen[chunk]).to(dev)
                if state is None:
                    top = masked_topk(user_embs, item_embs, chunk_users, chunk_seen, k)
                else:
                    top = distributed_masked_topk(state.mesh, user_embs[chunk_users], items_p,
                                                  chunk_seen, k, num_valid=n_items)[1]
                tops.append(top[:, :topN].cpu().numpy())
        top = np.concatenate(tops) if tops else np.zeros((0, 0), np.int64)
        preds = {int(u): top[i].tolist() for i, u in enumerate(users)}
        return evaluate_recall(preds, test_gd, topN)
