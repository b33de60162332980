"""RankTrainer and SequenceTrainer: the JAX package's trainer API on PyTorch.

RankTrainer's ``fit``, ``load_model``, ``save_model``, ``save_all``,
``save_train_model``, ``evaluate_model``, ``predict_dataloader`` and
``predict_dataframe`` keep the JAX package's names, signatures, checkpoint
file names and metric names.
The weights live in the model module itself: ``load_model`` copies a
checkpoint into it, and ``fit`` trains it where it stands, on the trainer's
device.

``fit`` takes the fused train step (``fused_update.py``: the table's Adam
update in one kernel pass) from a fresh state with Adam, as the JAX package
does, and the standard step (``steps.py``) when ``REC_PANGU_TPU_FUSED_ADAM=0``.
Two differences from the JAX ``fit``: it trains the module's weights as they
are (the JAX ``fit`` initializes new ones from ``seed``; here ``seed`` seeds
the generator the steps draw each step's dropout seed from, and the model's
constructor takes a ``seed`` for its weights), and ``resume_from``,
``mesh``, ``profile_dir`` and ``steps_per_call > 1`` raise
``NotImplementedError``.

SequenceTrainer drives sequence-recall models: ``load_model``, the
``save_*`` methods, ``evaluate_model`` (top-200 retrieval over the whole
corpus, then recall/ndcg/hitrate at each k, as in the JAX package) and
``fit``: per epoch the train steps (the sequence fused step with Adam from a
fresh state, or the standard step with ``REC_PANGU_TPU_FUSED_ADAM=0``), then
``evaluate_model`` on the valid loader, a row of ``log.csv``, the
``model_e_{i}`` checkpoint and early stopping.  ``seed`` seeds the
generator the steps draw their dropout seeds (and sampled negatives) from;
``mesh`` and ``steps_per_call > 1`` raise ``NotImplementedError``.  A model
with ``renorm_param_paths`` (CMI) trains projected: those rows are put back
on the unit sphere at the start of ``fit`` and after every step.

``device=None`` means the CUDA card (see ``utils/device.py``); a method's
``device`` argument, when given, overrides the trainer's.
"""
from __future__ import annotations

import csv
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..convert import jax_variables, load_jax_variables
from ..data.loader import DataLoader
from ..eval.metrics import RollingMetricBuffer, compute_ranking_metrics
from ..eval.retrieval import evaluate_recall, get_recall_predict
from ..models.sequence.augment import host_augment_sequences
from ..ops.graph import attach_session_graph
from ..utils.device import DeviceLike, resolve_device
from .ckpt import load_checkpoint, save_checkpoint
from .fused_update import maybe_enable_fused_update, maybe_enable_seq_fused_update
from .steps import StandardStep, make_param_renorm, strip_host_keys

logger = logging.getLogger("rec_pangu_tpu_torch")

# fit's arguments the port does not run yet, with the ROADMAP item that ports each
_NOT_PORTED = {
    "resume_from": "resume (ROADMAP Queue 1 item 11)",
    "mesh": "data-parallel and sharded training (ROADMAP Queue 1 item 10)",
    "profile_dir": "the trainer's profiler trace (ROADMAP Queue 1 item 11)",
    "steps_per_call": "K-step calls (ROADMAP Queue 1 item 11)",
}


class _BaseTrainer:
    """Checkpoints and the device, shared by the trainers."""

    def __init__(self, model_ckpt_dir: str = "./model_ckpt", device: DeviceLike = None):
        self.model_ckpt_dir = model_ckpt_dir
        self.device = resolve_device(device)
        self.step = 0  # optimizer steps taken; carried from a loaded checkpoint
        self.model = None
        self._train_step = None  # StandardStep or FusedStep, built by fit
        self._renorm = None      # the projection after each step (SequenceTrainer.fit)
        self._aug_rng = None     # the host augmentations' and negatives' generator

    def _device(self, device: DeviceLike) -> torch.device:
        return self.device if device is None else resolve_device(device)

    # ------------------------------------------------------------- ckpt api
    def load_model(self, model, path: str) -> dict:
        """Load a checkpoint (the JAX package's layout) into ``model``, move
        it to the trainer's device in eval mode, and return the checkpoint."""
        ckpt = load_checkpoint(path)
        load_jax_variables(model, {"params": ckpt["params"],
                                   "batch_stats": ckpt.get("batch_stats")})
        model.to(self.device).eval()
        self.step = int(ckpt.get("step", 0))
        return ckpt

    def save_model(self, model, model_ckpt_dir: str) -> str:
        """Weights-only checkpoint ``model.ckpt``, readable by both packages."""
        path = os.path.join(model_ckpt_dir, "model.ckpt")
        save_checkpoint(path, **jax_variables(model), step=self.step)
        return path

    def _opt_state(self):
        return None if self._train_step is None else self._train_step.opt_state(self.step)

    def save_all(self, model, enc_dict: dict, model_ckpt_dir: str) -> str:
        """Weights, optimizer state and enc_dict in ``model.ckpt``."""
        path = os.path.join(model_ckpt_dir, "model.ckpt")
        save_checkpoint(path, **jax_variables(model), opt_state=self._opt_state(),
                        enc_dict=enc_dict, step=self.step)
        logger.info(f"Model+enc_dict saved to {path}")
        return path

    def save_train_model(self, model, model_ckpt_dir: str, model_str: str) -> str:
        """Per-epoch checkpoint ``model_{model_str}.ckpt`` with optimizer state."""
        path = os.path.join(model_ckpt_dir, f"model_{model_str}.ckpt")
        save_checkpoint(path, **jax_variables(model), opt_state=self._opt_state(),
                        step=self.step)
        return path


class RankTrainer(_BaseTrainer):
    def __init__(self, num_task: int = 1, model_ckpt_dir: str = "./model_ckpt",
                 device: DeviceLike = None):
        super().__init__(model_ckpt_dir, device)
        self.num_task = num_task

    # ----------------------------------------------------------------- train
    def fit(self, model, train_loader: DataLoader, valid_loader: Optional[DataLoader] = None,
            epoch: int = 10, lr: float = 1e-3, device: DeviceLike = None,
            use_earlystopping: bool = False, max_patience: int = 999,
            monitor_metric: Optional[str] = None, lr_scheduler_type: str = "",
            scheduler_params: Optional[dict] = None, seed: int = 1029,
            log_rounds: int = 100, mesh=None, resume_from: Optional[str] = None,
            profile_dir: Optional[str] = None, steps_per_call: int = 1) -> Dict[str, float]:
        asked = {"resume_from": resume_from, "mesh": mesh, "profile_dir": profile_dir,
                 "steps_per_call": steps_per_call if int(steps_per_call) > 1 else None}
        for name, value in asked.items():
            if value is not None:
                raise NotImplementedError(f"fit({name}=...) is not ported yet: "
                                          f"{_NOT_PORTED[name]}")
        dev = self._device(device)
        os.makedirs(self.model_ckpt_dir, exist_ok=True)
        self.model = model.to(dev)
        self._fit_device = dev
        self.step = 0
        generator = torch.Generator().manual_seed(seed)
        steps_per_epoch = len(train_loader)
        self._train_step = maybe_enable_fused_update(
            model, lr, steps_per_epoch, lr_scheduler_type, scheduler_params, generator)
        if self._train_step is not None:
            logger.info("Embedding Adam update fused into the table kernel")
        else:
            self._train_step = StandardStep(model, lr, steps_per_epoch, lr_scheduler_type,
                                            scheduler_params, generator)
        n_params = sum(p.numel() for p in model.parameters())
        logger.info(f"Model initialized: {n_params:,} parameters")

        logger.info("Model Starting Training")
        best_epoch, best_metric = -1, -np.inf
        train_metric: Dict[str, float] = {}
        for i in range(1, epoch + 1):
            train_metric = self._train_one_epoch(train_loader, log_rounds)
            logger.info(f"Epoch {i} Train Metric:{train_metric}")
            if valid_loader is not None:
                valid_metric = self.evaluate_model(self.model, valid_loader, dev)
                self.save_train_model(self.model, self.model_ckpt_dir, f"e_{i}")
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

    def _step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One train step on a host batch: id check, upload, the step."""
        inputs = self.model.upload_batch(batch, self._fit_device, train=True)
        out = self._train_step(inputs, self.step)
        self.step += 1
        return out

    def _train_one_epoch(self, train_loader, log_rounds: int):
        # bounded train-metric accumulation: constant host memory per epoch
        window = int(os.environ.get("REC_PANGU_TPU_TRAIN_METRIC_WINDOW", str(1 << 20)))
        preds = RollingMetricBuffer(window)
        labels = RollingMetricBuffer(window)
        max_iter = len(train_loader)
        self.model.train()
        start = time.time()
        n_seen = 0
        for idx, batch in enumerate(train_loader):
            batch, _ = strip_host_keys(batch)
            out = self._step(batch)
            if self.num_task == 1:
                pred = out["pred"]
            else:
                pred = torch.cat([out[f"task{t + 1}_pred"].reshape(-1, 1)
                                  for t in range(self.num_task)], dim=1)
            preds.append(pred.detach())  # stays on the device until the epoch ends
            labels.append(batch["label"])
            n_seen += len(batch["label"])
            if idx % log_rounds == 0:
                loss = float(out["loss"].detach())
                elapsed = time.time() - start
                remaining = round(((elapsed / (idx + 1)) * (max_iter - idx + 1)) / 60, 2)
                logger.info(f"Iter {idx}/{max_iter} Remaining time:{remaining} min "
                            f"Loss:{round(loss, 4)}")
        pred_arr = preds.concat()
        label_arr = labels.concat()
        elapsed = time.time() - start
        logger.info(f"Epoch throughput: {n_seen / max(elapsed, 1e-9):,.0f} examples/s")
        return compute_ranking_metrics(label_arr, pred_arr, prefix="train_",
                                       num_task=self.num_task)

    # ------------------------------------------------------------- inference
    def _predict(self, model, batch, device: torch.device) -> np.ndarray:
        """[B, num_task] predictions of one host batch."""
        inputs = model.upload_batch(batch, device)
        with torch.inference_mode():
            out = model(inputs, train=False)
        if self.num_task == 1:
            pred = out["pred"].reshape(-1, 1)
        else:
            pred = torch.cat([out[f"task{t + 1}_pred"].reshape(-1, 1)
                              for t in range(self.num_task)], dim=1)
        return pred.cpu().numpy()

    def evaluate_model(self, model, test_loader: DataLoader,
                       device: DeviceLike = None) -> Dict[str, float]:
        """'roc_auc_score'/'log_loss' for one task, 'test_task{i}_*' for several."""
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

    def fit(self, model, train_loader: DataLoader, valid_loader: Optional[DataLoader] = None,
            epoch: int = 50, lr: float = 1e-3, device: DeviceLike = None,
            use_earlystopping: bool = False, max_patience: int = 999,
            monitor_metric: Optional[str] = None, log_rounds: int = 100,
            topk_list: Optional[List[int]] = None, lr_scheduler_type: str = "",
            scheduler_params: Optional[dict] = None, seed: int = 1029, mesh=None,
            steps_per_call: int = 1) -> None:
        asked = {"mesh": mesh, "steps_per_call": steps_per_call if int(steps_per_call) > 1
                 else None}
        for name, value in asked.items():
            if value is not None:
                raise NotImplementedError(f"fit({name}=...) is not ported yet: "
                                          f"{_NOT_PORTED[name]}")
        topk_list = topk_list or [20, 50, 100]
        dev = self._device(device)
        os.makedirs(self.model_ckpt_dir, exist_ok=True)
        self.model = model.to(dev)
        self._fit_device = dev
        self.step = 0
        generator = torch.Generator().manual_seed(seed)
        steps_per_epoch = len(train_loader)
        self._train_step = maybe_enable_seq_fused_update(
            model, lr, steps_per_epoch, lr_scheduler_type, scheduler_params,
            generator=generator)
        if self._train_step is not None:
            logger.info("Item-table Adam update fused into the table kernel "
                        "(history + softmax-CE gradients)")
        else:
            self._train_step = StandardStep(model, lr, steps_per_epoch, lr_scheduler_type,
                                            scheduler_params, generator)
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
            for idx, batch in enumerate(train_loader):
                batch, _ = strip_host_keys(batch)
                out = self._step(batch)
                if idx % log_rounds == 0:
                    loss = float(out["loss"].detach())
                    elapsed = time.time() - start
                    remaining = round(((elapsed / (idx + 1)) * (steps_per_epoch - idx + 1)) / 60,
                                      2)
                    logger.info(f"Iter {idx}/{steps_per_epoch} Remaining time:{remaining} min "
                                f"Loss:{round(loss, 4)}")
            if valid_loader is None:
                continue
            valid_metric = self.evaluate_model(self.model, valid_loader, dev,
                                               topk_list=topk_list)
            logger.info(f"Epoch {i} Valid Metric:{valid_metric}")
            log_rows.append({"epoch": i, **valid_metric})
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

    def _step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One train step on a host batch: the views of a ``host_aug`` model,
        the joint lookup ids of a ``lookup_extra`` model, the host session
        graph of a ``session_graph`` model, id check, upload, the step, then
        the projection of a ``renorm_param_paths`` model."""
        inputs = self.model.upload_batch(self._attach_host_keys(batch), self._fit_device,
                                         train=True)
        out = self._train_step(inputs, self.step)
        if self._renorm is not None:
            self._renorm()
        self.step += 1
        return out

    def _attach_host_keys(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
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

        Keys the batch already holds are kept."""
        model = self.model
        hist = np.asarray(batch["hist_item_list"])
        if getattr(model, "host_aug", False) and "aug_all" not in batch:
            if self._aug_rng is None:
                self._aug_rng = np.random.default_rng(10_301)
            views = [host_augment_sequences(self._aug_rng, hist, model.beta_a, model.beta_b,
                                            model.mask_token) for _ in range(2)]
            batch = {**batch, "aug_all": np.concatenate([hist] + views, axis=0)}
        if getattr(model, "host_negatives", False) and "neg_items" not in batch:
            if self._aug_rng is None:
                self._aug_rng = np.random.default_rng(10_301)
            high = max(model.item_emb.vocab_size - 1, 2)
            batch = {**batch, "neg_items": self._aug_rng.integers(1, high, hist.shape[0])
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
        rounded to 4 dp.  ``approx_recall_target`` is answered exactly."""
        topk_list = topk_list or [20, 50, 100]
        model.to(self._device(device)).eval()
        test_gd = test_loader.dataset.get_test_gd()
        preds = get_recall_predict(model, test_loader, topn=200,
                                   approx_recall_target=approx_recall_target)
        metric_dict: Dict[str, float] = {}
        for k in topk_list:
            res = evaluate_recall(preds, test_gd, k)
            logger.info(res)
            metric_dict.update(res)
        return metric_dict
