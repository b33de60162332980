"""Sequence augmentations of the contrastive sequence models (IOCRec).

Each augmented history is, with probability 1/2 each, the history with a
Beta(a, b) share of its positions replaced by the mask token, or the history
with a random contiguous window of that share of its length shuffled.

* ``host_augment_sequences``: numpy, drawn from a ``np.random.Generator``;
  the JAX package's ``host_augment_sequences``
  (``rec_pangu_tpu/models/sequence/contrarec.py``), the same draws in the same
  order, so both give the same views for the same generator state.  The
  trainer builds a training batch's ``aug_all`` with it.
* ``augment_sequences``: the same distribution on the device, drawn from an
  explicit ``torch.Generator``, for a training forward called without
  ``aug_all``.  The JAX package draws these from ``jax.random`` keys, whose
  bits torch cannot reproduce.
"""
from __future__ import annotations

import numpy as np
import torch


def host_augment_sequences(rng: np.random.Generator, item_seq, beta_a: float, beta_b: float,
                           mask_token: int) -> np.ndarray:
    """[B, L] histories -> one augmented view [B, L] of the same dtype."""
    hist = np.asarray(item_seq)
    B, L = hist.shape
    ratio = rng.beta(beta_a, beta_b, (B, 1))
    masked = np.where(rng.random((B, L)) < ratio, mask_token, hist)
    w = (ratio[:, 0] * L).astype(np.int32)
    start = (rng.random(B) * (L - w + 1)).astype(np.int32)
    pos = np.broadcast_to(np.arange(L)[None, :], (B, L))
    in_window = (pos >= start[:, None]) & (pos < (start + w)[:, None])
    noise = rng.uniform(-0.4, 0.4, (B, L))
    keys = np.where(in_window, pos + noise * w[:, None], pos.astype(np.float64))
    perm = np.argsort(keys, axis=1)
    reordered = np.take_along_axis(hist, perm, axis=1)
    choose_mask = rng.random((B, 1)) > 0.5
    return np.where(choose_mask, masked, reordered).astype(hist.dtype)


def fast_beta(generator: torch.Generator, a: float, b: float, shape, device=None) -> torch.Tensor:
    """Beta(a, b) for integer a, b >= 1: Gamma(k) is the sum of k Exp(1),
    -log of a product of k uniforms, and Beta(a, b) = Ga / (Ga + Gb)."""
    ia, ib = int(round(a)), int(round(b))
    if abs(a - ia) > 1e-6 or abs(b - ib) > 1e-6 or ia < 1 or ib < 1:
        raise ValueError(f"the device augmentation draws Beta(a, b) for integer a, b >= 1 "
                         f"only, got a={a}, b={b}")
    u = torch.rand(tuple(shape) + (ia + ib,), generator=generator, device=device)
    logs = torch.log(u * (1.0 - 1e-7) + 1e-7)  # uniform in [1e-7, 1), as in JAX
    ga = -logs[..., :ia].sum(dim=-1)
    gb = -logs[..., ia:].sum(dim=-1)
    return ga / (ga + gb)


def augment_sequences(generator: torch.Generator, item_seq: torch.Tensor, beta_a: float,
                      beta_b: float, mask_token: int) -> torch.Tensor:
    """[B, L] histories on the device -> one augmented view [B, L]."""
    B, L = item_seq.shape
    dev = item_seq.device
    ratio = fast_beta(generator, beta_a, beta_b, (B, 1), dev)
    mask_positions = torch.rand(B, L, generator=generator, device=dev) < ratio
    masked = torch.where(mask_positions, torch.full_like(item_seq, mask_token), item_seq)
    w = (ratio[:, 0] * L).to(torch.int32)
    start = (torch.rand(B, generator=generator, device=dev) * (L - w + 1)).to(torch.int32)
    pos = torch.arange(L, device=dev)[None, :].expand(B, L)
    in_window = (pos >= start[:, None]) & (pos < (start + w)[:, None])
    noise = torch.rand(B, L, generator=generator, device=dev) * 0.8 - 0.4
    keys = torch.where(in_window, pos + noise * w[:, None], pos.to(torch.float32))
    reordered = item_seq.gather(1, torch.argsort(keys, dim=1, stable=True))
    choose_mask = torch.rand(B, 1, generator=generator, device=dev) > 0.5
    return torch.where(choose_mask, masked, reordered)
