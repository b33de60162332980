"""What a run makes from ``--seed``: weights, id draws and batch pools.

Everything is drawn on the run's device from ``torch.Generator``s seeded by
``sub_seed(seed, tag)``, in a few large calls, so the same seed gives the
same inputs and weights and the reference can make them again.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) of run seed ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def make_weights(specs: Sequence[Tuple[str, Tuple[int, ...], float, float]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Float32 tensors, one a (name, shape, mean, std) spec: one standard
    normal draw over all of them, cut in spec order, each scaled and shifted.
    Every tensor is a copy of its own."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for (name, shape, mean, std), n in zip(specs, sizes):
        out[name] = flat[at:at + n].view(shape).mul(std).add_(mean)
        at += n
    del flat
    return out


def zipf_cdf(n: int, exponent: float, device) -> torch.Tensor:
    """The cumulative distribution [n] (float64) of ranks 1..n with
    probability proportional to rank ** -exponent."""
    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow(-float(exponent)), 0)
    return cdf / cdf[-1]


def zipf_ids(n: int, count: int, exponent: float, gen: torch.Generator,
             first: int = 0) -> torch.Tensor:
    """``count`` ids [count] int64 in [first, first + n): Zipf ranks, the hot
    ranks scattered over the range by a seeded permutation."""
    device = gen.device
    cdf = zipf_cdf(n, exponent, device)
    u = torch.rand(count, generator=gen, device=device, dtype=torch.float64)
    ranks = torch.searchsorted(cdf, u).clamp_(max=n - 1)
    perm = torch.randperm(n, generator=gen, device=device)
    return perm[ranks] + first


def split(t: torch.Tensor, parts: int) -> List[torch.Tensor]:
    """``t`` [parts * b, ...] as ``parts`` host arrays [b, ...]."""
    host = t.cpu().numpy()
    b = host.shape[0] // parts
    return [host[i * b:(i + 1) * b] for i in range(parts)]
