"""Pieces the plain references share: Adam, the counter-hash dropout masks,
per-leaf norms and the step seeds.

Plain PyTorch only: nothing here imports the program under test.  Each
function states the semantics the configurations state, written out again
from their definitions.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
SEED_RANGE = 2 ** 31 - 1  # a step's dropout seed lies in [0, 2**31 - 1)
_MASK32 = 0xFFFFFFFF


def step_seeds(fit_seed: int, steps: int) -> List[int]:
    """The dropout seeds of a fit's first ``steps`` steps: one draw a step,
    uniform in [0, 2**31 - 1), from a CPU ``torch.Generator`` seeded with the
    fit's seed (the trainers' documented seed stream)."""
    gen = torch.Generator().manual_seed(int(fit_seed))
    return [int(torch.randint(0, SEED_RANGE, (1,), generator=gen)[0]) for _ in range(steps)]


class Adam:
    """Dense Adam with bias correction over named float32 tensors, in optax's
    order: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).  A tensor whose
    gradient is zero still decays its moments and moves by them."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.params = params
        self.lr = float(lr)
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - ADAM_B1 ** self.t
        c2 = 1.0 - ADAM_B2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            self.v[k].mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + ADAM_EPS))


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The Euclidean norm of each tensor, accumulated in float64."""
    return {k: float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))
            for k, t in tensors.items()}


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 x in [0, 2**32), without overflowing int64."""
    return ((x & 0xFFFF) * c + (((x >> 16) * (c & 0xFFFF)) << 16)) & _MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit finalizer of the counter hash, on int64 tensors of uint32s."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_factors(seed: int, n: int, layer: int, site: int, shape: Sequence[int],
                    rate: float, device) -> torch.Tensor:
    """Inverted-dropout factors [n, *shape] float32 of the counter hash: element
    i (row-major in ``shape``) of sample s is kept when
    mix(key ^ mix(i)) >= rate * 2**32, with
    key = mix(mix(s ^ mix(seed ^ 0x9e3779b9)) ^ (3 * layer + site)), and then
    scaled by 1 / (1 - rate) rounded to float32."""
    base = int(mix32(torch.tensor([(int(seed) & _MASK32) ^ 0x9E3779B9], dtype=torch.int64))[0])
    samples = torch.arange(n, dtype=torch.int64, device=device)
    key = mix32(mix32(samples ^ base) ^ (3 * layer + site))
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device)
    draw = mix32(key[:, None] ^ mix32(idx)[None, :])
    keep = draw >= min(int(rate * 2.0 ** 32), _MASK32)
    scale = float(np.float32(1.0) / np.float32(1.0 - rate))
    return (keep.to(torch.float32) * scale).view(n, *shape)


def relative_gap(got: float, want: float) -> float:
    """|got - want| / |want| (inf for a non-finite reading)."""
    if not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              leaves: Iterable[str]) -> Dict[str, float]:
    """Per leaf: the gap between the two norms over the larger of the
    reference's norm of that leaf and of the median leaf."""
    leaves = list(leaves)
    median = float(np.median([want[k] for k in want]))
    out = {}
    for k in leaves:
        if not (math.isfinite(got[k]) and math.isfinite(want[k])):
            out[k] = math.inf
            continue
        out[k] = abs(got[k] - want[k]) / max(want[k], median, 1e-30)
    return out
