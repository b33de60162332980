"""Feature-interaction primitives (the FM inner product, four output modes)."""
from __future__ import annotations

from itertools import combinations

import torch


def _pair_indices(num_fields: int, device: torch.device):
    p, q = zip(*combinations(range(num_fields), 2))
    return (torch.tensor(p, dtype=torch.long, device=device),
            torch.tensor(q, dtype=torch.long, device=device))


def inner_product(feature_emb: torch.Tensor,
                  output: str = "product_sum_pooling") -> torch.Tensor:
    """FM pairwise interactions over [B, F, D].

    Modes: product_sum_pooling [B, 1]; Bi_interaction_pooling [B, D];
    inner_product [B, F(F-1)/2]; elementwise_product [B, F(F-1)/2, D].
    """
    if output in ("product_sum_pooling", "Bi_interaction_pooling"):
        sum_of_square = feature_emb.sum(dim=1) ** 2
        square_of_sum = (feature_emb ** 2).sum(dim=1)
        bi = (sum_of_square - square_of_sum) * 0.5
        if output == "Bi_interaction_pooling":
            return bi
        return bi.sum(dim=-1, keepdim=True)
    if output not in ("elementwise_product", "inner_product"):
        raise ValueError(f"inner_product output={output!r} is not supported")
    p, q = _pair_indices(feature_emb.shape[1], feature_emb.device)
    prod = feature_emb[:, p, :] * feature_emb[:, q, :]
    if output == "elementwise_product":
        return prod
    return prod.sum(dim=-1)
