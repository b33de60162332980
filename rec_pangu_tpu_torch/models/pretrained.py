"""Pretrained embedding rows, as the JAX package's ``models/pretrained.py``.

``build_pretrained_matrix`` makes a vocabulary-aligned ``[rows, D]``
matrix from ``{raw value: vector}`` (uniform random rows, from a seeded
numpy generator, for the values the dict lacks); ``inject_pretrained``
writes it into the feature's rows (``spec.feature_slice(col)``) of every
fused table of the model's shape ``[padded_rows(total_rows), D]`` and
returns the (table, rows) pairs it wrote.  Freezing those rows is the
standard step's ``frozen`` (``train/steps.py``), the counterpart of the
JAX package's ``freeze_rows_transform``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..data.encoder import OOV_SENTINEL, FeatureSpec
from ..ops.embedding import padded_rows


def build_pretrained_matrix(enc_dict: dict, col_name: str,
                            pretrained_dict: Dict[str, np.ndarray],
                            seed: int = 1029) -> np.ndarray:
    """Vocabulary-aligned [rows, D] float32 (rows = vocab_size + 1, the OOV
    row included)."""
    if col_name not in enc_dict:
        raise KeyError(f"Pretrained column {col_name!r} not in enc_dict")
    dim = len(next(iter(pretrained_dict.values())))
    rng = np.random.default_rng(seed)
    rows = int(enc_dict[col_name][OOV_SENTINEL]) + 1
    mat = rng.random((rows, dim), dtype=np.float64).astype(np.float32)
    for value, idx in enc_dict[col_name].items():
        if value == OOV_SENTINEL:
            continue
        vec = pretrained_dict.get(value)
        if vec is not None:
            mat[idx] = np.asarray(vec, dtype=np.float32)
    return mat


@torch.no_grad()
def inject_pretrained(model, enc_dict: dict, col_name: str,
                      pretrained_dict: Dict[str, np.ndarray],
                      embedding_dim: int) -> List[Tuple[torch.Tensor, slice]]:
    """Write the pretrained rows into each of ``model``'s tables (a weight
    at a flax path ending in ``table``) of shape
    ``[padded_rows(total_rows), embedding_dim]``; returns [(table, rows)]."""
    spec = FeatureSpec.from_enc_dict(enc_dict)
    rows = spec.feature_slice(col_name)
    matrix = build_pretrained_matrix(enc_dict, col_name, pretrained_dict)
    if matrix.shape[1] != embedding_dim:
        raise ValueError(f"Pretrained dim {matrix.shape[1]} != model embedding dim "
                         f"{embedding_dim}")
    shape = (padded_rows(spec.total_rows), embedding_dim)
    touched = []
    for coll, path, tensor, _ in model.jax_leaves():
        if coll == "params" and path[-1] == "table" and tuple(tensor.shape) == shape:
            tensor[rows] = torch.from_numpy(matrix).to(tensor.device)
            touched.append((tensor, rows))
    if not touched:
        raise ValueError("No fused embedding table matched the pretrained injection")
    return touched
