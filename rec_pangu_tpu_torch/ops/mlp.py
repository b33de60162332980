"""Configurable MLP, laid out like the JAX package's flax ``MLP``.

Per hidden layer: Linear -> [BatchNorm] -> activation -> [Dropout]; then an
optional output Linear and output activation.  ``dense[i]`` is flax's
``Dense_i`` (the output layer is the last), ``bn[i]`` is ``BatchNorm_i``.
A hidden layer whose activation is ``"dice"`` gets a ``Dice`` (flax's
``Dice_j``, j counting the Dice layers).
``train`` is an argument, as in the JAX package: it picks batch statistics
and active dropout.

BatchNorm is flax's (``flax_batch_norm``): ``momentum=0.9`` for the running
averages (torch ``momentum=0.1``), ``epsilon=1e-5``, the batch variance
E[x^2] - E[x]^2 clipped at 0, and the running variance updated with that
**biased** batch variance (torch's own update uses the unbiased one).
Under a mesh that splits the batch over ``data`` the statistics are the
global batch's (``_batch_moments``).

Weights: kaiming normal kernels and torch's uniform biases (the ranking
family), or with ``init="xavier"`` xavier normal kernels and zero biases
(the multi-task family, the JAX package's ``kernel_init=XAVIER``).

Dropout draws the port's hash masks (``ops/dropout.py``) for the step's
``seed``, on stream ``mlp_stream(dropout_stream, i)`` for hidden layer i: the
same elements on the card and the CPU.  Two MLPs of one model take other
``dropout_stream`` values.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..convert import prefixed
from .activations import Dice, get_activation
from .dropout import draw_seed, feature_dropout, mlp_stream
from .initializers import kaiming_normal_, torch_linear_bias_, xavier_normal_

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def _batch_moments(x: torch.Tensor, bn: nn.BatchNorm1d, dims: Tuple[int, ...]):
    """E[x] and E[x^2] over ``dims``: of this batch, or, while a mesh step
    runs a block of a batch split over ``data`` (``bn.mesh_state``, set by
    ``parallel/sharding.shard_state``), of the global batch: the blocks'
    sums added over ``data`` (a summing backward), as GSPMD computes the
    statistics of a sharded batch."""
    state = getattr(bn, "mesh_state", None)
    if state is None or not state.split:
        return x.mean(dim=dims), (x * x).mean(dim=dims)
    from ..parallel.comm import reduce_data  # here: the parallel package imports ops

    count = 1
    for d in dims:
        count *= x.shape[d]
    sums = reduce_data(torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims)]), state.data_group)
    return sums[0] / (count * state.n_data), sums[1] / (count * state.n_data)


def flax_batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, train: bool,
                    dims: Sequence[int] = (0,)) -> torch.Tensor:
    """flax ``BatchNorm`` over ``x`` with the features on the axis not in
    ``dims`` (the statistics' axes): in training, the batch's mean and
    biased variance normalize ``x`` and move ``bn``'s running averages by
    ``bn.momentum`` (``BN_MOMENTUM``, torch's convention); in eval, the
    running averages normalize it."""
    dims = tuple(dims)
    shape = [1] * x.dim()
    feat = next(i for i in range(x.dim()) if i not in dims)
    shape[feat] = x.shape[feat]
    if train:
        mean, mean_sq = _batch_moments(x, bn, dims)
        var = (mean_sq - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(mean.detach(), alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum).add_(var.detach(), alpha=bn.momentum)
    else:
        mean, var = bn.running_mean, bn.running_var
    if not bn.affine:  # flax's use_scale=False, use_bias=False (Dice's)
        return (x - mean.view(shape)) * torch.rsqrt(var + bn.eps).view(shape)
    scale = bn.weight * torch.rsqrt(var + bn.eps)
    return (x - mean.view(shape)) * scale.view(shape) + bn.bias.view(shape)


def bn_leaves(name: str, bn: nn.BatchNorm1d) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
    """flax ``BatchNorm`` leaves of ``bn`` under the module name ``name``."""
    return [("params", (name, "scale"), bn.weight, False),
            ("params", (name, "bias"), bn.bias, False),
            ("batch_stats", (name, "mean"), bn.running_mean, False),
            ("batch_stats", (name, "var"), bn.running_var, False)]


class MLP(nn.Module):
    def __init__(self, input_dim: int, hidden_units: Sequence[int],
                 output_dim: Optional[int] = None,
                 hidden_activations: Union[str, Sequence[str]] = "relu",
                 output_activation: Optional[str] = None,
                 dropout_rates: Union[float, Sequence[float]] = 0.1,
                 batch_norm: bool = False, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None, dropout_stream: int = 0,
                 init: str = "kaiming"):
        super().__init__()
        if init not in ("kaiming", "xavier"):
            raise ValueError(f"init must be 'kaiming' or 'xavier', got {init!r}")
        self.dropout_stream = int(dropout_stream)
        n = len(hidden_units)
        acts = ([hidden_activations] * n if isinstance(hidden_activations, str)
                else list(hidden_activations))
        drops = (list(dropout_rates) if isinstance(dropout_rates, (list, tuple))
                 else [dropout_rates] * n)
        self.dice = nn.ModuleList()
        self.acts = []
        for a, units in zip(acts, hidden_units):
            if isinstance(a, str) and a.lower() == "dice":
                self.dice.append(Dice(units))
                self.acts.append(self.dice[-1])
            else:
                self.acts.append(get_activation(a) if a else None)
        self.drops = [float(d or 0.0) for d in drops]
        self.output_act = (get_activation(output_activation)
                           if output_activation is not None else None)
        widths = list(hidden_units) + ([output_dim] if output_dim is not None else [])
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dense = nn.ModuleList()
        fan_in = input_dim
        for units in widths:
            layer = nn.Linear(fan_in, units, bias=use_bias)
            if init == "xavier":
                xavier_normal_(layer.weight, generator)
                if use_bias:
                    nn.init.zeros_(layer.bias)
            else:
                kaiming_normal_(layer.weight, generator)
                if use_bias:
                    torch_linear_bias_(layer.bias, fan_in, generator)
            self.dense.append(layer)
            fan_in = units
        self.bn = nn.ModuleList(
            [nn.BatchNorm1d(u, eps=BN_EPS, momentum=BN_MOMENTUM) for u in hidden_units]
            if batch_norm else [])

    def forward(self, x: torch.Tensor, train: bool = False,
                seed: Optional[int] = None) -> torch.Tensor:
        """``train`` applies dropout with the masks of ``seed`` (drawn from
        torch's default generator when None)."""
        if train and seed is None and any(d > 0 for d in self.drops):
            seed = draw_seed()
        for i in range(len(self.acts)):
            x = self.dense[i](x)
            if len(self.bn):
                x = flax_batch_norm(x, self.bn[i], train)
            if isinstance(self.acts[i], Dice):
                x = self.acts[i](x, train)
            elif self.acts[i] is not None:
                x = self.acts[i](x)
            if train and self.drops[i] > 0:
                x = feature_dropout(x, self.drops[i], seed,
                                    mlp_stream(self.dropout_stream, i))
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
            leaves += bn_leaves(f"BatchNorm_{i}", bn)
        for j, dice in enumerate(self.dice):
            leaves += prefixed(f"Dice_{j}", dice.jax_leaves())
        return leaves
