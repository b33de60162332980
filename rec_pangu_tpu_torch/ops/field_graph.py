"""FiGNN's field-graph layers, the JAX package's ``ops/field_graph.py``,
weights under its flax names.  No model of the package builds them; they
are part of its layer library.

* ``GraphLayer``: one message pass over the fields, per-field ``[F, D, D]``
  weights ``W_out`` (out of the sender) and ``W_in`` (into the receiver),
  one einsum each, and ``bias_p``.
* ``FiGNNLayer``: the attention adjacency over every field pair (a Dense of
  the pair's two embeddings, leaky relu, self-loops masked to -inf, softmax
  over the senders), then ``gnn_layers`` graph layers (one reused, or one
  each), each followed by flax ``GRUCell``'s update (or a sum) and the
  residual.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..convert import prefixed
from .initializers import flax_lecun_normal_, flax_xavier_normal_
from .sequence_enc import GRULayer, _dense, _linear_leaves

Leaves = List[Tuple[str, tuple, torch.Tensor, bool]]


class GraphLayer(nn.Module):
    """g [B, F, F], h [B, F, D] -> [B, F, D]: ``W_in_f (sum_g g[f, g] W_out_g
    h_g) + bias_p``."""

    def __init__(self, num_fields: int, embedding_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        shape = (num_fields, embedding_dim, embedding_dim)
        self.W_in = nn.Parameter(flax_xavier_normal_(torch.empty(shape), gen))
        self.W_out = nn.Parameter(flax_xavier_normal_(torch.empty(shape), gen))
        self.bias_p = nn.Parameter(torch.zeros(embedding_dim))

    def forward(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        h_out = torch.einsum("fde,bfe->bfd", self.W_out, h)
        aggr = torch.einsum("bfg,bgd->bfd", g, h_out)
        return torch.einsum("fde,bfe->bfd", self.W_in, aggr) + self.bias_p

    def jax_leaves(self) -> Leaves:
        return [("params", ("W_in",), self.W_in, False),
                ("params", ("W_out",), self.W_out, False),
                ("params", ("bias_p",), self.bias_p, False)]


class FiGNNLayer(nn.Module):
    """feature_emb [B, F, D] -> [B, F, D]; weights ``W_attn`` (Dense 2D -> 1
    without bias, fan-in normal), ``gnn`` (reused) or ``gnn_{i}``, and
    ``gru`` (flax ``GRUCell``'s gates and init) when ``use_gru``."""

    def __init__(self, num_fields: int, embedding_dim: int, gnn_layers: int = 3,
                 reuse_graph_layer: bool = False, use_gru: bool = True,
                 use_residual: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.num_fields = int(num_fields)
        self.gnn_layers = int(gnn_layers)
        self.reuse_graph_layer = bool(reuse_graph_layer)
        self.use_residual = bool(use_residual)
        self.W_attn = _dense(2 * embedding_dim, 1, gen, bias=False)
        count = 1 if self.reuse_graph_layer else self.gnn_layers
        self.gnn = nn.ModuleList(GraphLayer(num_fields, embedding_dim, gen) for _ in range(count))
        self.gru = None
        if use_gru:
            self.gru = GRULayer(embedding_dim, embedding_dim, gen)
            for g in GRULayer.GATES:  # flax GRUCell's own input init
                flax_lecun_normal_(getattr(self.gru, f"i{g}_kernel"), gen)

    def adjacency(self, feature_emb: torch.Tensor) -> torch.Tensor:
        """[B, F, F]: row f the softmax over the other fields of the leaky
        relu (slope 0.01) of ``W_attn`` of [e_f, e_g]; -inf on the diagonal."""
        F_ = self.num_fields
        src = feature_emb.repeat_interleave(F_, dim=1)               # [B, F*F, D]
        dst = feature_emb.repeat(1, F_, 1)                           # [B, F*F, D]
        alpha = F.leaky_relu(self.W_attn(torch.cat([src, dst], dim=-1))[..., 0],
                             negative_slope=0.01).reshape(-1, F_, F_)
        eye = torch.eye(F_, dtype=torch.bool, device=feature_emb.device)
        alpha = alpha.masked_fill(eye, float("-inf"))
        return torch.softmax(alpha, dim=-1)

    def forward(self, feature_emb: torch.Tensor) -> torch.Tensor:
        D = feature_emb.shape[-1]
        g = self.adjacency(feature_emb)
        h = feature_emb
        for i in range(self.gnn_layers):
            a = self.gnn[0 if self.reuse_graph_layer else i](g, h)
            if self.gru is not None:
                h = self.gru.cell(a.reshape(-1, D), h.reshape(-1, D)).view_as(feature_emb)
            else:
                h = a + h
            if self.use_residual:
                h = h + feature_emb
        return h

    def jax_leaves(self) -> Leaves:
        leaves = _linear_leaves(self, ("W_attn",))
        if self.reuse_graph_layer:
            leaves += prefixed("gnn", self.gnn[0].jax_leaves())
        else:
            for i, layer in enumerate(self.gnn):
                leaves += prefixed(f"gnn_{i}", layer.jax_leaves())
        if self.gru is not None:
            leaves += prefixed("gru", self.gru.jax_leaves())
        return leaves
