"""AFN: the logarithmic neuron network (log of the clipped |embeddings|,
BatchNorm over the fields, a Linear over the fields to the logarithmic
neurons, exp, BatchNorm over the neurons, an MLP) and, with
``ensemble_dnn``, an MLP over a second table of its own (``embedding2``),
fused by a Dense(2 -> 1).  Both MLPs take the defaults (dropout 0.1) on
their own dropout streams.

The BatchNorms are flax's over the field (resp. neuron) axis of [B, F, D]:
the statistics over B and D, the running variance moved by the biased
batch variance (``ops/mlp.flax_batch_norm``)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...convert import prefixed
from ...ops.embedding import FusedEmbedding
from ...ops.mlp import BN_EPS, BN_MOMENTUM, MLP, bn_leaves, flax_batch_norm
from ...ops.sequence_enc import _dense, _linear_leaves
from ..base import RankModelBase, register_model
from ..losses import get_loss_fn


@register_model("AFN")
class AFN(RankModelBase):
    def __init__(self, enc_dict: dict, embedding_dim: int = 32,
                 dnn_hidden_units: Sequence[int] = (64, 64, 64),
                 afn_hidden_units: Sequence[int] = (64, 64, 64), ensemble_dnn: bool = True,
                 logarithmic_neurons: int = 5, loss_fun: str = "bce", seed: int = 1029):
        super().__init__(enc_dict)
        gen = torch.Generator().manual_seed(seed)
        self.embedding_dim = int(embedding_dim)
        self.loss_fn = get_loss_fn(loss_fun)
        self.ensemble_dnn = bool(ensemble_dnn)
        F, D = self.num_sparse, self.embedding_dim
        self.embedding = FusedEmbedding(self.spec, D, generator=gen)
        self.log_bn = nn.BatchNorm1d(F, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.Dense_0 = _dense(F, logarithmic_neurons, gen, bias=False)
        self.exp_bn = nn.BatchNorm1d(logarithmic_neurons, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.afn_mlp = MLP(logarithmic_neurons * D, afn_hidden_units, output_dim=1,
                           generator=gen, dropout_stream=0)
        if self.ensemble_dnn:
            self.embedding2 = FusedEmbedding(self.spec, D, generator=gen)
            self.dnn_mlp = MLP(F * D, dnn_hidden_units, output_dim=1, generator=gen,
                               dropout_stream=1)
            self.Dense_1 = _dense(2, 1, gen)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        emb = self.embedding(batch["sparse"], capture)                    # [B, F, D]
        log_x = flax_batch_norm(torch.log(emb.abs().clamp_min(1e-5)), self.log_bn, train,
                                dims=(0, 2))
        cross = torch.exp(self.Dense_0(log_x.transpose(1, 2)).transpose(1, 2))  # [B, n, D]
        cross = flax_batch_norm(cross, self.exp_bn, train, dims=(0, 2))
        logit = self.afn_mlp(cross.reshape(cross.shape[0], -1), train, seed)
        if self.ensemble_dnn:
            emb2 = self.embedding2(batch["sparse"], capture)
            dnn_out = self.dnn_mlp(emb2.reshape(emb2.shape[0], -1), train, seed)
            logit = self.Dense_1(torch.cat([logit, dnn_out], dim=-1))
        return self.outputs(torch.sigmoid(logit), batch, train)

    def jax_leaves(self):
        leaves = (prefixed("FusedEmbedding_0", self.embedding.jax_leaves())
                  + bn_leaves("log_bn", self.log_bn) + _linear_leaves(self, ("Dense_0",))
                  + bn_leaves("exp_bn", self.exp_bn)
                  + prefixed("MLP_0", self.afn_mlp.jax_leaves()))
        if self.ensemble_dnn:
            leaves += (prefixed("embedding2", self.embedding2.jax_leaves())
                       + prefixed("MLP_1", self.dnn_mlp.jax_leaves())
                       + _linear_leaves(self, ("Dense_1",)))
        return leaves
