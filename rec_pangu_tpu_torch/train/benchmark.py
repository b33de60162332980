"""BenchmarkTrainer, the JAX package's model-sweep runner
(``train/benchmark.py``): train each named model with ``RankTrainer`` on the
same loaders, and write the wall-clock train and test times and the valid
and test metrics of each to a CSV, one row a model.

The columns are the JAX package's: ``model_name``, ``train_model_time(ms)``,
``test_model_time(ms)``, ``examples_per_s`` (train examples over the train
time, set-up included), then ``valid_<metric>`` and ``test_<metric>`` (a
multi-task model's metrics already start with ``test_``, so its columns
read ``valid_test_task1_...``, as the reference's sweep writes them).
pandas is imported by ``run`` only.  ``run(mesh=...)`` passes the mesh on
to every ``fit``, as the JAX package's does: every rank runs the sweep,
and global rank 0 alone writes the CSV.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch

from ..models import get_model
from ..utils.device import DeviceLike
from ..utils.logging import logger
from .trainer import RankTrainer


class BenchmarkTrainer:
    def __init__(self, model_list: List[str], num_task: int = 1,
                 model_ckpt_dir: str = "./benchmark_ckpt",
                 benchmark_res_path: str = "./benchmark_res.csv"):
        self.model_list = model_list
        self.num_task = num_task
        self.model_ckpt_dir = model_ckpt_dir
        self.benchmark_res_path = benchmark_res_path

    def run(self, train_loader, valid_loader, test_loader, enc_dict: dict,
            epoch: int = 10, lr: float = 1e-3, device: DeviceLike = None,
            model_kwargs: Optional[Dict[str, dict]] = None, mesh=None):
        """Train and test every model of ``model_list`` on ``device`` (the
        CUDA card by default), under ``mesh`` when given; returns the
        results as a pandas DataFrame, also written to
        ``benchmark_res_path`` after each model."""
        import pandas as pd

        rows = []
        model_kwargs = model_kwargs or {}
        for model_name in self.model_list:
            logger.info(f"Benchmark: training {model_name}")
            model = get_model(model_name)(enc_dict=enc_dict,
                                          **model_kwargs.get(model_name, {}))
            trainer = RankTrainer(num_task=self.num_task, device=device,
                                  model_ckpt_dir=os.path.join(self.model_ckpt_dir, model_name))
            t0 = time.time()
            trainer.fit(model, train_loader, valid_loader, epoch=epoch, lr=lr, mesh=mesh)
            train_s = time.time() - t0
            n_examples = epoch * sum(len(b["label"]) for b in train_loader)
            valid_metric = trainer.evaluate_model(model, valid_loader)
            t0 = time.time()
            test_metric = trainer.evaluate_model(model, test_loader)
            row = {"model_name": model_name,
                   "train_model_time(ms)": round(train_s * 1000, 1),
                   "test_model_time(ms)": round((time.time() - t0) * 1000, 1),
                   "examples_per_s": round(n_examples / max(train_s, 1e-9), 1)}
            row.update({f"valid_{k}": v for k, v in valid_metric.items()})
            row.update({f"test_{k}": v for k, v in test_metric.items()})
            rows.append(row)
            if mesh is None or torch.distributed.get_rank() == 0:
                pd.DataFrame(rows).to_csv(self.benchmark_res_path, index=False)
            logger.info(f"Benchmark row: {row}")
        return pd.DataFrame(rows)
