"""Contrastive losses of CLRec and ContraRec, term for term as in the JAX
package's ``models/sequence/contra_losses.py``.

* ``clrec_contra_loss``: two-view InfoNCE of each user against its own
  target item, the batch's other targets the negatives.
* ``contrarec_contra_loss``: the supervised contrastive loss over the
  concatenated views, positives being views of the same target item, each
  view's similarity to itself left out, scaled by the temperature.

Both take L2-normalized features and are plain ``torch.matmul`` products.
"""
from __future__ import annotations

from typing import Optional

import torch


def clrec_contra_loss(features: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """features [B, 2, D], already normalized."""
    B = features.shape[0]
    mask = torch.eye(B, dtype=features.dtype, device=features.device)
    dot = torch.matmul(features[:, 0], features[:, 1].t()) / temperature
    logits = dot - dot.amax(dim=1, keepdim=True)
    log_prob = logits - torch.log(torch.exp(logits).sum(dim=1, keepdim=True) + 1e-10)
    return -(mask * log_prob).sum(dim=1).mean()


def contrarec_contra_loss(features: torch.Tensor, labels: Optional[torch.Tensor] = None,
                          temperature: float = 0.2) -> torch.Tensor:
    """features [B, V, D] normalized; labels [B] target items (positives:
    equal labels), or None for InfoNCE."""
    B, V, D = features.shape
    dev, dt = features.device, features.dtype
    if labels is None:
        mask = torch.eye(B, dtype=dt, device=dev)
    else:
        labels = labels.reshape(-1, 1)
        mask = (labels == labels.t()).to(dt)
    contrast = features.transpose(0, 1).reshape(B * V, D)
    dot = torch.matmul(contrast, contrast.t()) / temperature
    logits = dot - dot.amax(dim=1, keepdim=True)  # self-similarity included
    logits_mask = 1.0 - torch.eye(B * V, dtype=dt, device=dev)
    mask = mask.repeat(V, V) * logits_mask
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True) + 1e-10)
    mean_log_prob_pos = (mask * log_prob).sum(dim=1) / (mask.sum(dim=1) + 1e-10)
    return (-temperature * mean_log_prob_pos).mean()
