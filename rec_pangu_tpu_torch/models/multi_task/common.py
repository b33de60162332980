"""What the multi-task models share: ``TaskTower``, ``multi_task_bce``,
the expert bank and the family's init.

The family initializes every Linear xavier normal with zero biases and its
table per feature (``FusedEmbedding(init_mode="xavier")``), as the JAX
package's ``XAVIER`` convention does.  A model takes ``dropouts`` as the
JAX class does; every dropout site draws the port's hash masks
(``ops/dropout.py``), task i's tower on MLP stream i.

The expert bank (MMOE, OMOE, MLMMOE) is a raw ``[H, M, E]`` tensor and an
``[M, E]`` bias, not Linears: they carry across as they are, not
transposed, under the flax names ``experts`` and ``experts_bias``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ...convert import prefixed
from ...ops.activations import get_activation
from ...ops.mlp import MLP
from ..base import RankModelBase
from ..losses import bce_loss


@torch.no_grad()
def normal_init(shape, generator: torch.Generator) -> nn.Parameter:
    """flax ``normal(stddev=1.0)``: the JAX package's ``NORMAL_INIT``."""
    return nn.Parameter(torch.empty(*shape).normal_(0.0, 1.0, generator=generator))


@torch.no_grad()
def uniform_init(shape, generator: torch.Generator) -> nn.Parameter:
    """flax ``uniform(scale=1.0)``, U[0, 1) (not symmetric): ``UNIFORM_INIT``."""
    return nn.Parameter(torch.empty(*shape).uniform_(0.0, 1.0, generator=generator))


class TaskTower(MLP):
    """One task's tower: per hidden layer Linear -> BatchNorm (flax's,
    momentum 0.9) -> Dropout, with **no activation** (the reference's own
    quirk, kept), then Linear(1) -> sigmoid -> [B].  Weights under the flax
    names ``Dense_i`` and ``BatchNorm_i``, as ``MLP``'s."""

    def __init__(self, input_dim: int, hidden_dim: Sequence[int] = (128, 64),
                 dropouts: Sequence[float] = (0.2, 0.2),
                 generator: Optional[torch.Generator] = None, dropout_stream: int = 0):
        super().__init__(input_dim, hidden_dim, output_dim=1,
                         hidden_activations=[None] * len(hidden_dim),
                         dropout_rates=list(dropouts), batch_norm=True, generator=generator,
                         dropout_stream=dropout_stream, init="xavier")

    def forward(self, x: torch.Tensor, train: bool = False,
                seed: Optional[int] = None) -> torch.Tensor:
        return torch.sigmoid(super().forward(x, train, seed))[:, 0]


def multi_task_bce(task_preds: List[torch.Tensor], labels: torch.Tensor) -> torch.Tensor:
    """The mean over tasks of each task's BCE; labels [B, T]."""
    T = len(task_preds)
    loss = 0.0
    for i, pred in enumerate(task_preds):
        loss = loss + bce_loss(pred, labels[:, i]) / T
    return loss


class MultiTaskBase(RankModelBase):
    """``outputs`` of a multi-task model: ``task{i}_pred`` [B] for each
    task, plus ``loss`` (``loss_of``) in training when the batch has a
    label [B, T]."""

    def outputs(self, preds: List[torch.Tensor], batch, train: bool):
        out = {f"task{i + 1}_pred": p for i, p in enumerate(preds)}
        if train and "label" in batch:
            out["loss"] = self.loss_of(preds, batch["label"])
        return out

    def loss_of(self, preds: List[torch.Tensor], labels: torch.Tensor) -> torch.Tensor:
        return multi_task_bce(preds, labels)


class ExpertBank(nn.Module):
    """``experts_out[b, m, e] = sum_h x[b, h] experts[h, m, e] +
    experts_bias[m, e]``, then ``expert_activation`` when given: the JAX
    einsum ``ij,jkl->ikl`` as one product."""

    def __init__(self, input_dim: int, hidden: int, n_expert: int, experts_init,
                 generator: torch.Generator, expert_activation: Optional[str] = None):
        super().__init__()
        self.experts = experts_init((input_dim, hidden, n_expert), generator)
        self.experts_bias = uniform_init((hidden, n_expert), generator)
        self.act = (get_activation(expert_activation) if expert_activation is not None
                    else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, M, E = self.experts.shape
        out = torch.matmul(x, self.experts.reshape(H, M * E)).reshape(-1, M, E)
        out = out + self.experts_bias
        return self.act(out) if self.act is not None else out

    def jax_leaves(self):
        return [("params", ("experts",), self.experts, False),
                ("params", ("experts_bias",), self.experts_bias, False)]


def mix(experts_out: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """[B, M, E] weighted by a gate [B, E] over the experts -> [B, M] (the
    JAX einsum ``bke,be->bk``)."""
    return torch.bmm(experts_out, gate.unsqueeze(-1))[..., 0]


class TaskGates(nn.Module):
    """Per task i, ``softmax(x @ gate_i + gate_bias_i)`` over the experts
    (flax names ``gate_{i+1}``, ``gate_bias_{i+1}``)."""

    def __init__(self, input_dim: int, n_expert: int, num_task: int,
                 generator: torch.Generator):
        super().__init__()
        self.num_task = int(num_task)
        for i in range(1, self.num_task + 1):
            setattr(self, f"gate_{i}", normal_init((input_dim, n_expert), generator))
            setattr(self, f"gate_bias_{i}", uniform_init((n_expert,), generator))

    def forward(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Task ``i``'s gate [B, E] (0-based)."""
        w, b = getattr(self, f"gate_{i + 1}"), getattr(self, f"gate_bias_{i + 1}")
        return torch.softmax(torch.matmul(x, w) + b, dim=-1)

    def jax_leaves(self):
        return [("params", (f"{kind}_{i}",), getattr(self, f"{kind}_{i}"), False)
                for i in range(1, self.num_task + 1) for kind in ("gate", "gate_bias")]


def towers(input_dim: int, num_task: int, hidden_dim, dropouts,
           generator: torch.Generator) -> nn.ModuleList:
    """``TaskTower`` i on dropout stream i, flax name ``task_{i+1}_dnn``."""
    return nn.ModuleList(TaskTower(input_dim, hidden_dim, dropouts, generator, i)
                         for i in range(num_task))


def tower_leaves(towers_: nn.ModuleList):
    return [leaf for i, t in enumerate(towers_)
            for leaf in prefixed(f"task_{i + 1}_dnn", t.jax_leaves())]
