"""Numeric helpers safe under autograd.

``torch.linalg.norm`` has a NaN gradient at an exactly-zero vector (0/0),
and zero vectors are common here: the item table's row 0 reads as zero.
``safe_l2norm`` divides by ``sqrt(sum(x * x) + eps)``, which is
differentiable everywhere and maps a zero row to a zero row.  The JAX
package's ``ops/numerics.py``.
"""
from __future__ import annotations

import torch


def safe_l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(dim=dim, keepdim=True) + eps)
