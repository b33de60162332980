"""Model base classes and registry.

A ranking model is an ``nn.Module`` whose ``forward(batch, train=False)``
takes a dict of tensors ``{'sparse': [B, F] i32, 'dense': [B, Nd] f32}``
and returns ``{'pred': [B, 1]}``, plus ``'loss'`` when ``train`` and a
label are given.  ``forward(..., capture=list)`` is the fused train step's
capture mode (``ops/embedding.FusedEmbedding.forward``).

A sequence-recall model takes ``{'hist_item_list': [B, L] i32,
'hist_mask_list': [B, L] f32}`` and returns ``{'user_emb': [B, D]}``
(``[B, K, D]`` for a multi-interest model), plus ``'loss'`` when ``train``
(the batch then also holds ``'target_item'`` [B] i32).  Its
``forward(batch, train, capture=None, seed=None)``: ``capture`` is the
sequence fused step's ``{"hist": [], "ce": []}`` (the history rows and the
softmax CE's dense item gradient), ``seed`` the step's dropout seed.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.encoder import OOV_SENTINEL, FeatureSpec
from ..ops.embedding import ItemEmbedding, check_ids, check_item_ids
from ..ops.softmax_ce import (_FUSED_MIN_VOCAB, fused_ce_enabled, fused_softmax_ce_captured,
                              fused_softmax_ce_padded, full_softmax_ce)

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


class SequenceModelBase(nn.Module):
    """Shared machinery of the sequence-recall models.

    Children call ``setup_base()`` in their ``__init__`` for ``item_emb``
    and one ``ItemEmbedding`` per ``config['cate_cols']`` column
    (``cate_embs``), and list their weights under flax names in
    ``jax_leaves``.  ``config`` keys follow the JAX package (embedding_dim,
    max_length, item_col, emb_init_std, ...); ``seed`` seeds the weights."""

    input_dtypes = {"hist_item_list": np.int32, "hist_mask_list": np.float32}
    # True on a model whose only item-table uses in the training forward are
    # the history lookup and the full-softmax CE, the two the sequence fused
    # step captures (train/fused_update.py); any other read of the table
    # would lose its gradient there
    fused_update_compatible = False
    # False: the loss never reaches the captured CE, so the fused step passes
    # no dense gradient to the table's Adam pass
    fused_uses_ce = True

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

    def calculate_loss(self, user_emb: torch.Tensor, pos_item: torch.Tensor,
                       capture: Optional[List[torch.Tensor]] = None,
                       seed: Optional[int] = None) -> torch.Tensor:
        """The training loss of ``user_emb`` [B, D] against the item corpus,
        on the JAX package's branches: the captured streaming CE when the
        fused step passes ``capture`` (its backward appends the table's dense
        gradient there; the table gets none), the sampled softmax for
        ``config['loss_type'] == 'sampled'``, else the full softmax CE,
        streamed over the raw table from 65,536 items (unless
        ``REC_PANGU_TPU_FUSED_CE=0``), over ``output_items()`` below."""
        table = self.item_emb.table
        vocab = self.item_emb.vocab_size
        if capture is not None:
            return fused_softmax_ce_captured(user_emb, table.detach(), pos_item, capture, vocab)
        if self.config.get("loss_type", "full") == "sampled":
            gen = None
            if seed is not None:
                gen = torch.Generator(device=user_emb.device).manual_seed(int(seed) + 1)
            return self.calculate_sampled_loss(
                user_emb, pos_item, int(self.config.get("num_negatives", 1024)), gen)
        if fused_ce_enabled() and vocab >= _FUSED_MIN_VOCAB:
            return fused_softmax_ce_padded(user_emb, table, pos_item, vocab)
        return full_softmax_ce(user_emb, self.output_items(), pos_item)

    def calculate_sampled_loss(self, user_emb: torch.Tensor, pos_item: torch.Tensor,
                               num_negatives: int = 1024,
                               generator: Optional[torch.Generator] = None,
                               neg_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sampled-softmax CE: the positive against ``num_negatives`` item ids
        shared by the batch, uniform in [1, vocab) (0 is padding), drawn from
        ``generator`` (on ``user_emb``'s device; torch's default generator
        when None), or the given ``neg_ids``.  The JAX package falls back to
        a constant key here; the port always draws."""
        all_items = self.output_items()
        v = all_items.shape[0]
        if neg_ids is None:
            neg_ids = torch.randint(1, v, (num_negatives,), generator=generator,
                                    device=user_emb.device)
        pos = pos_item.reshape(-1).long()
        pos_scores = (user_emb * all_items[pos]).sum(dim=-1, keepdim=True)
        neg_scores = torch.matmul(user_emb, all_items[neg_ids.long()].t())
        logits = torch.cat([pos_scores, neg_scores], dim=1)
        return -torch.log_softmax(logits, dim=-1)[:, 0].mean()

    def calculate_multimax_sampled_loss(self, user_embs: torch.Tensor, pos_item: torch.Tensor,
                                        num_negatives: int = 1024,
                                        generator: Optional[torch.Generator] = None,
                                        neg_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sampled K-max CE for [B, K, D] multi-interest embeddings: each
        candidate's logit is its best over the interests, the positive
        against ``num_negatives`` shared negatives drawn as in
        ``calculate_sampled_loss`` (or the given ``neg_ids``)."""
        all_items = self.output_items()
        v = all_items.shape[0]
        if neg_ids is None:
            neg_ids = torch.randint(1, v, (num_negatives,), generator=generator,
                                    device=user_embs.device)
        pos = pos_item.reshape(-1).long()
        pos_scores = (user_embs * all_items[pos][:, None, :]).sum(dim=-1).amax(dim=1,
                                                                               keepdim=True)
        neg_scores = torch.einsum("bkd,nd->bkn", user_embs,
                                  all_items[neg_ids.long()]).amax(dim=1)
        logits = torch.cat([pos_scores, neg_scores], dim=1)
        return -torch.log_softmax(logits, dim=-1)[:, 0].mean()

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
        to ``device``; a training batch (``train``) also checks and uploads
        its ``target_item`` (int32) and, when it holds them, the host-made
        views ``aug_all`` [3B, L] (int32)."""
        dtypes = dict(self.input_dtypes)
        check_item_ids(batch["hist_item_list"], self.item_emb.vocab_size)
        if train:
            keys = ("target_item", "aug_all") if "aug_all" in batch else ("target_item",)
            for key in keys:
                check_item_ids(batch[key], self.item_emb.vocab_size)
                dtypes[key] = np.int32
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k], dtype=dt)).to(device)
                for k, dt in dtypes.items()}

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        raise NotImplementedError
