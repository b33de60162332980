"""Multi-interest extraction layers: ComiRec-SA's self-attention and the
capsule network of ComiRec-DR and MIND.

The JAX package's ``ops/multi_interest.py``, weights under its flax names:

* ``MultiInterestSelfAttention`` (``W1`` [D, 4D], ``W2`` [4D, K]):
  A = softmax over the sequence of tanh(H W1) W2 - 1e9 (1 - mask), and the
  interests A^T H [B, K, D].
* ``CapsuleNetwork``: dynamic routing, three iterations, no stop-gradient
  (the gradient flows through every iteration, as in the JAX package).
  Bilinear type 0 (MIND): one shared ``linear`` [D, H] tiled over the K
  interests, routing logits drawn from a gaussian; type 1: a ``linear``
  [D, K H]; type 2 (ComiRec-DR): a per-position ``w`` [1, L, K H, H],
  kept in flax's layout, applied as one batched product over the positions
  (the JAX package's broadcast product would hold [B, L, K H, H], 3.4 GB
  at 1024 histories of 50 with K = 4 and H = 64).  Types 1 and 2 start
  from zero logits.

MIND's gaussian logits: the caller may pass them (``routing_logits`` [B, K,
L]).  Otherwise a train step draws them on its own device from a generator
of that device seeded by the step's seed, and serving uses one draw from
``SERVING_ROUTING_SEED``, made on the CPU once for each shape and device and
kept, so a request is deterministic and the card serves the CPU's logits.
The JAX package draws them from the step's ``routing`` key in training and
from ``PRNGKey(0)`` without one: the same distribution, other numbers.

Plain torch on both devices: the products are ``torch.matmul`` (the JAX
package computes them outside any Pallas kernel).
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
from torch import nn

from .initializers import kaiming_normal_

ROUTING_TIMES = 3          # the capsule network's routing iterations
SERVING_ROUTING_SEED = 0   # MIND's routing logits outside training
ROUTING_SEED_OFFSET = 2    # ... in training: the step's seed plus this


class MultiInterestSelfAttention(nn.Module):
    def __init__(self, embedding_dim: int, num_interests: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        d = 4 * embedding_dim
        self.W1 = nn.Parameter(torch.empty(embedding_dim, d))
        self.W2 = nn.Parameter(torch.empty(d, num_interests))
        kaiming_normal_(self.W1, gen)
        kaiming_normal_(self.W2, gen)

    def forward(self, seq: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """seq [B, L, D], mask [B, L] or [B, L, 1] (1 at items) -> [B, K, D]."""
        A = torch.matmul(torch.tanh(torch.matmul(seq, self.W1)), self.W2)   # [B, L, K]
        if mask is not None:
            if mask.dim() == 2:
                mask = mask[..., None]
            A = A + -1e9 * (1.0 - mask.to(A.dtype))
        A = torch.softmax(A, dim=1)
        return torch.matmul(A.transpose(1, 2), seq)

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        return [("params", ("W1",), self.W1, False), ("params", ("W2",), self.W2, False)]


def squash(s: torch.Tensor) -> torch.Tensor:
    norm_sq = (s * s).sum(dim=-1, keepdim=True)
    return (norm_sq / (1 + norm_sq) / torch.sqrt(norm_sq + 1e-9)) * s


@functools.lru_cache(maxsize=8)
def _serving_routing_logits(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(SERVING_ROUTING_SEED)
    return torch.randn(shape, generator=gen).to(device)


def draw_routing_logits(shape, seed: Optional[int], device: torch.device) -> torch.Tensor:
    """MIND's gaussian routing logits [B, K, L]: with a train step's
    ``seed``, drawn on ``device`` from its generator seeded by ``seed`` plus
    ROUTING_SEED_OFFSET; with None, the serving draw (SERVING_ROUTING_SEED,
    on the CPU, kept for each shape and device).  A ``RowSeed`` of a
    data-parallel block draws the global batch's logits and takes the
    block's rows, so each rank starts from the single-device step's."""
    device = torch.device(device)
    if seed is None:
        return _serving_routing_logits(tuple(int(n) for n in shape), device)
    gen = torch.Generator(device=device).manual_seed(int(seed) + ROUTING_SEED_OFFSET)
    rows = getattr(seed, "batch_rows", 0)
    if rows:
        first = seed.first_row
        return torch.randn((rows,) + tuple(shape[1:]), generator=gen,
                           device=device)[first:first + shape[0]]
    return torch.randn(shape, generator=gen, device=device)


class CapsuleNetwork(nn.Module):
    def __init__(self, hidden_size: int, seq_len: int, bilinear_type: int = 2,
                 interest_num: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        if bilinear_type not in (0, 1, 2):
            raise ValueError(f"bilinear_type must be 0, 1 or 2, got {bilinear_type}")
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        H, K = int(hidden_size), int(interest_num)
        self.hidden_size, self.seq_len, self.interest_num = H, int(seq_len), K
        self.bilinear_type = int(bilinear_type)
        if bilinear_type == 2:
            self.w = nn.Parameter(torch.empty(1, self.seq_len, K * H, H))
            kaiming_normal_(self.w, gen)
        else:
            self.linear = nn.Linear(H, H if bilinear_type == 0 else K * H, bias=False)
            kaiming_normal_(self.linear.weight, gen)

    def forward(self, item_eb: torch.Tensor, mask: torch.Tensor,
                routing_logits: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        """item_eb [B, L, H], mask [B, L] -> interests [B, K, H].  Type 0
        starts routing from ``routing_logits`` [B, K, L] when given, else
        from ``draw_routing_logits`` of ``seed`` (the train step's; None
        outside training)."""
        B, S, _ = item_eb.shape
        K, H = self.interest_num, self.hidden_size
        if self.bilinear_type == 0:
            hat = self.linear(item_eb).repeat(1, 1, K)                  # [B, S, K H]
        elif self.bilinear_type == 1:
            hat = self.linear(item_eb)
        else:  # hat[b, s] = w[0, s] @ item_eb[b, s], batched over the positions
            hat = torch.matmul(self.w[0], item_eb.permute(1, 2, 0)).permute(2, 0, 1)
        hat = hat.reshape(B, S, K, H).transpose(1, 2)                    # [B, K, S, H]
        if self.bilinear_type > 0:
            weight = item_eb.new_zeros(B, K, S)
        elif routing_logits is not None:
            weight = routing_logits.to(item_eb.dtype).detach()
        else:
            weight = draw_routing_logits((B, K, S), seed, item_eb.device).to(item_eb.dtype)
        keep = (mask[:, None, :] != 0).expand(B, K, S)
        capsule = None
        for i in range(ROUTING_TIMES):
            c = torch.where(keep, torch.softmax(weight, dim=-1), 0.0)[:, :, None, :]
            capsule = squash(torch.matmul(c, hat))                       # [B, K, 1, H]
            if i < ROUTING_TIMES - 1:
                weight = weight + torch.matmul(hat, capsule.transpose(2, 3))[..., 0]
        return capsule.reshape(B, K, H)

    def jax_leaves(self) -> List[Tuple[str, tuple, torch.Tensor, bool]]:
        if self.bilinear_type == 2:
            return [("params", ("w",), self.w, False)]
        return [("params", ("linear", "kernel"), self.linear.weight, True)]
