"""Initializers matching the reference's effective init, drawn from an
explicit ``torch.Generator``.

* Embedding tables ``[rows, D]``: kaiming normal with torch's fan-in
  ``shape[1]``, i.e. std ``sqrt(2 / D)`` whatever the vocabulary size.
* Linear kernels: fan-in normal, std ``sqrt(2 / in)`` (the flax
  ``variance_scaling(2.0, "fan_in", "normal")`` the JAX package uses, which
  is :func:`kaiming_normal_` on a torch ``Linear.weight`` ``[out, in]``).
* Linear biases: torch's default ``U(-1/sqrt(in), 1/sqrt(in))``.
* Kernels kept in flax's layout ``[..., in, out]`` (the GRU's input
  kernels, the conv kernels): the same fan-in normal with flax's fan-in
  ``prod(shape[:-1])`` (:func:`flax_fan_in_normal_`).
* The multi-task family's Linears: xavier normal, std
  ``sqrt(2 / (in + out))``, and zero biases (:func:`xavier_normal_`).
* NGCF's weights and the field graph's ``[F, D, D]`` ones: flax's own
  ``xavier_normal``, a normal truncated at two standard deviations, scaled
  to the variance ``2 / (fan_in + fan_out)`` (:func:`flax_xavier_normal_`).
* The field graph's GRU input kernels: flax ``GRUCell``'s default
  ``lecun_normal`` (:func:`flax_lecun_normal_`).

The same seed gives other numbers than the JAX package's ``jax.random``:
parity tests carry weights across with :mod:`rec_pangu_tpu_torch.convert`.
"""
from __future__ import annotations

import math

import torch


@torch.no_grad()
def kaiming_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """std = sqrt(2 / fan_in) with torch's fan_in = shape[1] * prod(shape[2:])."""
    if t.dim() < 2:
        raise ValueError("kaiming_normal_ is for >=2-D tensors")
    fan_in = t.shape[1] * math.prod(t.shape[2:])
    return t.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


@torch.no_grad()
def torch_linear_bias_(bias: torch.Tensor, fan_in: int,
                       generator: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    return bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def flax_fan_in_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """std = sqrt(2 / fan_in) with flax's fan_in = prod(shape[:-1]) of a
    kernel in flax's layout ``[..., in, out]``."""
    if t.dim() < 2:
        raise ValueError("flax_fan_in_normal_ is for >=2-D kernels")
    return t.normal_(0.0, math.sqrt(2.0 / math.prod(t.shape[:-1])), generator=generator)


@torch.no_grad()
def xavier_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """std = sqrt(2 / (fan_in + fan_out)) of a torch ``Linear.weight`` [out,
    in] (flax's ``xavier_normal`` of the same kernel as [in, out])."""
    if t.dim() != 2:
        raise ValueError("xavier_normal_ is for 2-D Linear weights")
    return t.normal_(0.0, math.sqrt(2.0 / (t.shape[0] + t.shape[1])), generator=generator)


_TRUNCATED_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


def _truncated_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """flax's truncated normal of ``std``: a standard normal truncated to
    [-2, 2], times ``std / 0.8796``."""
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std / _TRUNCATED_STD)


@torch.no_grad()
def flax_xavier_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``xavier_normal`` of a weight of two or more axes, std
    ``sqrt(2 / (fan_in + fan_out))``: of a 2-D weight in either layout (the
    fans only add); of one in flax's layout ``[..., in, out]`` with flax's
    fans, each times the leading axes' product."""
    if t.dim() < 2:
        raise ValueError("flax_xavier_normal_ is for weights of two or more axes")
    receptive = math.prod(t.shape[:-2])
    return _truncated_normal_(
        t, math.sqrt(2.0 / ((t.shape[-2] + t.shape[-1]) * receptive)), generator)


@torch.no_grad()
def flax_lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` of a kernel in flax's layout ``[..., in,
    out]``: a truncated normal of std ``sqrt(1 / fan_in)``, flax's fan-in
    ``prod(shape[:-1])`` (flax ``GRUCell``'s input kernels)."""
    if t.dim() < 2:
        raise ValueError("flax_lecun_normal_ is for >=2-D kernels")
    return _truncated_normal_(t, math.sqrt(1.0 / math.prod(t.shape[:-1])), generator)
