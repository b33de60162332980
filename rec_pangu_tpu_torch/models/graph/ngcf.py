"""NGCF, the JAX package's ``models/graph/ngcf.py``.

User and item tables, stacked NGCF layers over the bipartite graph, the
concatenation of every layer's embeddings, and the BPR loss with an L2
term scaled by ``lmbd``.  The graph is the dense normalized interaction
matrix ``g`` = R_norm [U, I] (``data/graph_dataset.generate_graph``), a
buffer that ``.to(device)`` moves and no checkpoint holds: messages to the
users are ``R_norm @ item_h``, to the items ``R_norm^T @ user_h``, two
dense products a layer (``torch.matmul``, as the JAX package computes
them; the backward of each is one more pass over R_norm, by autograd).

``forward(batch, train=False, seed=None)``: in training the batch holds
``user_id``, ``pos_item_id`` and ``neg_item_id`` [B] and the output is
``{"loss"}``; in eval it is ``{"user_emb": [U, D (1 + layers)],
"item_emb": [I, ...]}``.  ``seed`` is the step's dropout seed (layer i's
masks on streams (``NGCF_DROPOUT_LAYER`` + i, 0) for the users and (..., 1)
for the items); the constructor's ``seed`` makes the weights.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...convert import prefixed
from ...ops.dropout import NGCF_DROPOUT_LAYER, draw_seed
from ...ops.graph import NGCFLayer
from ...ops.initializers import flax_xavier_normal_
from ..base import register_model


@register_model("NGCF")
class NGCF(nn.Module):
    input_dtypes = {"user_id": np.int32, "pos_item_id": np.int32, "neg_item_id": np.int32}

    def __init__(self, num_user: int = 0, num_item: int = 0, embedding_dim: int = 64,
                 hidden_size: Sequence[int] = (64, 64), dropout: float = 0.1,
                 lmbd: float = 1e-5, g=None, seed: int = 1029):
        super().__init__()
        self.num_user, self.num_item = int(num_user), int(num_item)
        self.embedding_dim = int(embedding_dim)
        self.lmbd = float(lmbd)
        gen = torch.Generator().manual_seed(seed)
        self.user_emb = nn.Parameter(
            flax_xavier_normal_(torch.empty(self.num_user, self.embedding_dim), gen))
        self.item_emb = nn.Parameter(
            flax_xavier_normal_(torch.empty(self.num_item, self.embedding_dim), gen))
        dims = [self.embedding_dim] + [int(h) for h in hidden_size]
        self.ngcf_layers = nn.ModuleList(NGCFLayer(dims[i], dims[i + 1], dropout, gen)
                                         for i in range(len(dims) - 1))
        if g is None:
            g = torch.zeros(self.num_user, self.num_item)
        g = torch.as_tensor(g, dtype=torch.float32)
        if tuple(g.shape) != (self.num_user, self.num_item):
            raise ValueError(f"g has shape {tuple(g.shape)}, expected "
                             f"({self.num_user}, {self.num_item})")
        self.register_buffer("g", g, persistent=False)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        if train and seed is None:
            seed = draw_seed()
        r = self.g
        user_h, item_h = self.user_emb, self.item_emb
        user_embeds, item_embeds = [user_h], [item_h]
        for i, layer in enumerate(self.ngcf_layers):
            side_u = torch.matmul(r, item_h)        # [U, D]
            side_i = torch.matmul(r.t(), user_h)    # [I, D]
            user_h, item_h = (
                layer(side_u, user_h, train, seed, (NGCF_DROPOUT_LAYER + i, 0)),
                layer(side_i, item_h, train, seed, (NGCF_DROPOUT_LAYER + i, 1)))
            user_embeds.append(user_h)
            item_embeds.append(item_h)
        user_embd = torch.cat(user_embeds, dim=1)
        item_embd = torch.cat(item_embeds, dim=1)
        if not train:
            return {"user_emb": user_embd, "item_emb": item_embd}
        u = user_embd[batch["user_id"].long()]
        pos = item_embd[batch["pos_item_id"].long()]
        neg = item_embd[batch["neg_item_id"].long()]
        return {"loss": self.bpr_loss(u, pos, neg)}

    def bpr_loss(self, users: torch.Tensor, pos_items: torch.Tensor,
                 neg_items: torch.Tensor) -> torch.Tensor:
        pos_scores = (users * pos_items).sum(dim=1)
        neg_scores = (users * neg_items).sum(dim=1)
        mf_loss = -torch.nn.functional.logsigmoid(pos_scores - neg_scores).mean()
        regularizer = ((users ** 2).sum() + (pos_items ** 2).sum()
                       + (neg_items ** 2).sum()) / 2
        return mf_loss + self.lmbd * regularizer / users.shape[0]

    def upload_batch(self, batch: Dict[str, np.ndarray], device: torch.device,
                     train: bool = False) -> Dict[str, torch.Tensor]:
        """Check a BPR batch's ids (ValueError before any upload) and copy
        them to ``device`` as int32; an eval call reads no batch."""
        if not train:
            return {}
        for key, high in (("user_id", self.num_user), ("pos_item_id", self.num_item),
                          ("neg_item_id", self.num_item)):
            ids = np.asarray(batch[key])
            if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= high):
                raise ValueError(f"{key} out of range [0, {high})")
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k], dtype=dt)).to(device)
                for k, dt in self.input_dtypes.items()}

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        leaves = [("params", ("user_emb",), self.user_emb, False),
                  ("params", ("item_emb",), self.item_emb, False)]
        for i, layer in enumerate(self.ngcf_layers):
            leaves += prefixed(f"ngcf_layers_{i}", layer.jax_leaves())
        return leaves
