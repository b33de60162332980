"""AOANet: an MLP branch (dropout 0.1, no output layer) beside the
generalized interaction net (outer-product subspaces fused by alpha, W and
h) -> Dense(1)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...convert import prefixed
from ...ops.embedding import FusedEmbedding
from ...ops.initializers import kaiming_normal_
from ...ops.mlp import MLP
from ...ops.sequence_enc import _dense, _linear_leaves
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


class GeneralizedInteraction(nn.Module):
    """One layer of the generalized interaction net: ``W`` [out, D, D],
    ``alpha`` [in * F, out] and ``h`` [out, D, 1], each the reference's
    kaiming overwrite (torch's fan-in ``shape[1] * prod(shape[2:])``).
    Pair n = s F + f of subspace s of b_i and field f of b_0; alpha is
    contracted into the product first, so nothing larger than [B, out, D, D]
    is built:

        fusion[b, o, h, d] = sum_{s, f} alpha[s F + f, o] b0[b, f, h] bi[b, s, d]
        out[b, o, h] = sum_d fusion[b, o, h, d] W[o, h, d] h[o, d]
    """

    def __init__(self, input_subspaces: int, output_subspaces: int, num_fields: int,
                 embedding_dim: int, generator: torch.Generator):
        super().__init__()
        D = embedding_dim
        self.input_subspaces, self.num_fields = int(input_subspaces), int(num_fields)
        self.W = nn.Parameter(torch.empty(output_subspaces, D, D))
        self.alpha = nn.Parameter(torch.empty(input_subspaces * num_fields, output_subspaces))
        self.h = nn.Parameter(torch.empty(output_subspaces, D, 1))
        for t in (self.W, self.alpha, self.h):
            kaiming_normal_(t, generator)

    def forward(self, b0: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
        alpha3 = self.alpha.view(self.input_subspaces, self.num_fields, -1)
        a1 = torch.einsum("bfh,sfo->bsoh", b0, alpha3)
        fusion = torch.einsum("bsoh,bsd->bohd", a1, bi)               # [B, out, D, D]
        g = self.W * self.h.transpose(1, 2)                            # W[o,h,d] h[o,d]
        return torch.einsum("bohd,ohd->boh", fusion, g)

    def jax_leaves(self):
        return [("params", ("W",), self.W, False), ("params", ("alpha",), self.alpha, False),
                ("params", ("h",), self.h, False)]


@register_model("AOANet")
class AOANet(RankModelBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32,
                 dnn_hidden_units: Sequence[int] = (64, 64, 64),
                 num_interaction_layers: int = 3, num_subspaces: int = 4,
                 loss_fun: str = "bce", seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        self.loss_fn = get_loss_fn(loss_fun)
        F = self.num_sparse
        self.embedding = FusedEmbedding(self.spec, self.embedding_dim, generator=gen)
        self.mlp = MLP(self.dnn_input_dim(self.embedding_dim), dnn_hidden_units,
                       output_dim=None, generator=gen)
        self.gin = nn.ModuleList(
            GeneralizedInteraction(F if i == 0 else num_subspaces, num_subspaces, F,
                                   self.embedding_dim, gen)
            for i in range(num_interaction_layers))
        width = dnn_hidden_units[-1] + num_subspaces * self.embedding_dim
        self.Dense_0 = _dense(width, 1, gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)
        dnn_input = torch.cat([emb.reshape(emb.shape[0], -1), batch["dense"]], dim=1)
        dnn_out = self.mlp(dnn_input, train, seed)
        bi = emb
        for layer in self.gin:
            bi = layer(emb, bi)
        logit = self.Dense_0(torch.cat([dnn_out, bi.reshape(bi.shape[0], -1)], dim=-1))
        return self.outputs(torch.sigmoid(logit), batch, train)

    def jax_leaves(self):
        leaves = (prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                  + prefixed("MLP_0", self.mlp.jax_leaves()))
        for i, layer in enumerate(self.gin):
            leaves += prefixed(f"GeneralizedInteraction_{i}", layer.jax_leaves())
        return leaves + _linear_leaves(self, ("Dense_0",))
