"""Configurable MLP, laid out like the JAX package's flax ``MLP``.

Per hidden layer: Linear -> [BatchNorm] -> activation -> [Dropout]; then an
optional output Linear and output activation.  ``dense[i]`` is flax's
``Dense_i`` (the output layer is the last), ``bn[i]`` is ``BatchNorm_i``.
BatchNorm matches flax's ``momentum=0.9`` (torch ``momentum=0.1``) and
``epsilon=1e-5``.  ``train`` is an argument, as in the JAX package: it picks
batch statistics and active dropout.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .activations import get_activation
from .initializers import kaiming_normal_, torch_linear_bias_

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class MLP(nn.Module):
    def __init__(self, input_dim: int, hidden_units: Sequence[int],
                 output_dim: Optional[int] = None,
                 hidden_activations: Union[str, Sequence[str]] = "relu",
                 output_activation: Optional[str] = None,
                 dropout_rates: Union[float, Sequence[float]] = 0.1,
                 batch_norm: bool = False, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = len(hidden_units)
        acts = ([hidden_activations] * n if isinstance(hidden_activations, str)
                else list(hidden_activations))
        drops = (list(dropout_rates) if isinstance(dropout_rates, (list, tuple))
                 else [dropout_rates] * n)
        self.acts = [get_activation(a) if a else None for a in acts]
        self.drops = [float(d or 0.0) for d in drops]
        self.output_act = (get_activation(output_activation)
                           if output_activation is not None else None)
        widths = list(hidden_units) + ([output_dim] if output_dim is not None else [])
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dense = nn.ModuleList()
        fan_in = input_dim
        for units in widths:
            layer = nn.Linear(fan_in, units, bias=use_bias)
            kaiming_normal_(layer.weight, generator)
            if use_bias:
                torch_linear_bias_(layer.bias, fan_in, generator)
            self.dense.append(layer)
            fan_in = units
        self.bn = nn.ModuleList(
            [nn.BatchNorm1d(u, eps=BN_EPS, momentum=BN_MOMENTUM) for u in hidden_units]
            if batch_norm else [])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(len(self.acts)):
            x = self.dense[i](x)
            if len(self.bn):
                bn = self.bn[i]
                x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                                 bn.bias, training=train, momentum=BN_MOMENTUM,
                                 eps=BN_EPS)
            if self.acts[i] is not None:
                x = self.acts[i](x)
            if self.drops[i] > 0:
                x = F.dropout(x, self.drops[i], training=train)
        if len(self.dense) > len(self.acts):
            x = self.dense[-1](x)
        if self.output_act is not None:
            x = self.output_act(x)
        return x

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        """(collection, flax path, tensor, transposed) of each weight."""
        leaves = []
        for i, layer in enumerate(self.dense):
            leaves.append(("params", (f"Dense_{i}", "kernel"), layer.weight, True))
            if layer.bias is not None:
                leaves.append(("params", (f"Dense_{i}", "bias"), layer.bias, False))
        for i, bn in enumerate(self.bn):
            leaves += [("params", (f"BatchNorm_{i}", "scale"), bn.weight, False),
                       ("params", (f"BatchNorm_{i}", "bias"), bn.bias, False),
                       ("batch_stats", (f"BatchNorm_{i}", "mean"), bn.running_mean, False),
                       ("batch_stats", (f"BatchNorm_{i}", "var"), bn.running_var, False)]
        return leaves
