"""Model base classes and registry.

A ranking model is an ``nn.Module`` whose ``forward(batch, train=False)``
takes a dict of tensors ``{'sparse': [B, F] i32, 'dense': [B, Nd] f32}``
and returns ``{'pred': [B, 1]}``, plus ``'loss'`` when ``train`` and a
label are given.  ``forward(..., capture=list)`` is the fused train step's
capture mode (``ops/embedding.FusedEmbedding.forward``).

A sequence-recall model takes ``{'hist_item_list': [B, L] i32,
'hist_mask_list': [B, L] f32}`` and returns ``{'user_emb': [B, D]}``
(``[B, K, D]`` for a multi-interest model).  Its losses arrive with
sequence training.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..data.encoder import OOV_SENTINEL, FeatureSpec
from ..ops.embedding import ItemEmbedding, check_ids, check_item_ids

MODEL_REGISTRY: Dict[str, type] = {}


def register_model(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        MODEL_REGISTRY[name] = cls
        MODEL_REGISTRY[name.lower()] = cls
        return cls

    return deco


def get_model(name: str) -> type:
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if name.lower() in MODEL_REGISTRY:
        return MODEL_REGISTRY[name.lower()]
    raise KeyError(f"Unknown model {name!r}; registered: "
                   f"{sorted(k for k in MODEL_REGISTRY if not k.islower())}")


class RankModelBase(nn.Module):
    """Children build their layers in ``__init__`` from ``enc_dict`` and
    list their weights under flax names in ``jax_leaves``."""

    # batch keys the model reads, with their types; the rest stay on the host
    input_dtypes = {"sparse": np.int32, "dense": np.float32}

    def __init__(self, enc_dict: dict):
        super().__init__()
        self.enc_dict = enc_dict
        self.spec = FeatureSpec.from_enc_dict(enc_dict)

    @property
    def num_sparse(self) -> int:
        return self.spec.num_sparse

    @property
    def num_dense(self) -> int:
        return self.spec.num_dense

    def dnn_input_dim(self, embedding_dim: int) -> int:
        return self.num_sparse * embedding_dim + self.num_dense

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        raise NotImplementedError

    def upload_batch(self, batch: Dict[str, np.ndarray], device: torch.device,
                     train: bool = False) -> Dict[str, torch.Tensor]:
        """Check a host batch's ids against the table (ValueError before any
        upload) and copy the keys the model reads to ``device``; a training
        batch (``train``) also uploads its float32 ``label``."""
        check_ids(self.spec, batch["sparse"], self.embedding.table.shape[0])
        dtypes = dict(self.input_dtypes, label=np.float32) if train else self.input_dtypes
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k], dtype=dt)).to(device)
                for k, dt in dtypes.items()}


_SEQ_TRAINING = "sequence training arrives with SASRec training (ROADMAP Queue 1 item 3b)"


class SequenceModelBase(nn.Module):
    """Shared machinery of the sequence-recall models.

    Children call ``setup_base()`` in their ``__init__`` for ``item_emb``
    and one ``ItemEmbedding`` per ``config['cate_cols']`` column
    (``cate_embs``), and list their weights under flax names in
    ``jax_leaves``.  ``config`` keys follow the JAX package (embedding_dim,
    max_length, item_col, emb_init_std, ...); ``seed`` seeds the weights."""

    input_dtypes = {"hist_item_list": np.int32, "hist_mask_list": np.float32}

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__()
        self.enc_dict = enc_dict
        self.config = dict(config)
        self.generator = torch.Generator().manual_seed(seed)

    def setup_base(self) -> None:
        item_col = self.config.get("item_col", "item_id")
        vocab = int(self.enc_dict[item_col][OOV_SENTINEL])
        std = self.config.get("emb_init_std")
        std = float(std) if std is not None else None
        self.item_emb = ItemEmbedding(vocab, self.embedding_dim, std, self.generator)
        self.cate_embs = nn.ModuleDict({
            col: ItemEmbedding(int(self.enc_dict[col][OOV_SENTINEL]), self.embedding_dim, std,
                               self.generator)
            for col in self.config.get("cate_cols", []) or []})

    @property
    def embedding_dim(self) -> int:
        return int(self.config["embedding_dim"])

    @property
    def max_length(self) -> int:
        return int(self.config["max_length"])

    def output_items(self) -> torch.Tensor:
        """The item corpus [vocab, D], row 0 zeroed."""
        return self.item_emb.all_items()

    def calculate_loss(self, user_emb, pos_item):
        raise NotImplementedError(_SEQ_TRAINING)

    def calculate_sampled_loss(self, user_emb, pos_item, num_negatives: int = 1024):
        raise NotImplementedError(_SEQ_TRAINING)

    @staticmethod
    def gather_indexes(output: torch.Tensor, gather_index: torch.Tensor) -> torch.Tensor:
        """[B, L, D] taken at per-row position [B] -> [B, D]."""
        return output[torch.arange(output.shape[0], device=output.device),
                      gather_index.reshape(-1).long()]

    @staticmethod
    def get_attention_mask(attention_mask: torch.Tensor) -> torch.Tensor:
        """[B, L] 0/1 mask -> additive causal mask [B, 1, L, L]: 0 where a
        query may see a key, -1e6 elsewhere."""
        L = attention_mask.shape[-1]
        causal = torch.ones(L, L, dtype=attention_mask.dtype,
                            device=attention_mask.device).tril()
        return (1.0 - attention_mask[:, None, None, :] * causal) * -1e6

    def upload_batch(self, batch: Dict[str, np.ndarray], device: torch.device,
                     train: bool = False) -> Dict[str, torch.Tensor]:
        """Check a host batch's item ids against the vocabulary (ValueError
        before any upload) and copy the history ids (int32) and mask (f32)
        to ``device``."""
        if train:
            raise NotImplementedError(_SEQ_TRAINING)
        check_item_ids(batch["hist_item_list"], self.item_emb.vocab_size)
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k], dtype=dt)).to(device)
                for k, dt in self.input_dtypes.items()}

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        raise NotImplementedError
