"""RankTrainer: the serving half of the JAX package's trainer API.

``load_model``, ``save_model``, ``evaluate_model``, ``predict_dataloader``
and ``predict_dataframe`` keep the JAX package's names, signatures and
metric names.  The weights live in the model module itself: ``load_model``
copies a checkpoint into it and moves it to the trainer's device.

``device=None`` means the CUDA card (see ``utils/device.py``); a method's
``device`` argument, when given, overrides the trainer's.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..convert import jax_variables, load_jax_variables
from ..data.loader import DataLoader
from ..eval.metrics import compute_ranking_metrics
from ..utils.device import DeviceLike, resolve_device
from .ckpt import load_checkpoint, save_checkpoint


class RankTrainer:
    def __init__(self, num_task: int = 1, model_ckpt_dir: str = "./model_ckpt",
                 device: DeviceLike = None):
        self.num_task = num_task
        self.model_ckpt_dir = model_ckpt_dir
        self.device = resolve_device(device)
        self.step = 0  # carried from the loaded checkpoint into saved ones

    def fit(self, *args, **kwargs):
        raise NotImplementedError(
            "training is not ported yet: RankTrainer.fit arrives with the "
            "training slice of the port")

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

    # ------------------------------------------------------------- inference
    def _device(self, device: DeviceLike) -> torch.device:
        return self.device if device is None else resolve_device(device)

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
