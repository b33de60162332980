"""MIND: the capsule network with one shared projection (bilinear type 0)
and gaussian routing logits, the best interest for the target item through
the full-softmax CE.

The JAX package's ``models/sequence/mind.py``, its weights under the same
flax names (``capsule/linear/kernel``).  The routing logits come from the
batch's ``routing_logits`` [B, K, L] when it holds them, else from
``ops/multi_interest.draw_routing_logits``: in training drawn on the step's
device from the step's seed, in serving one fixed draw kept for each shape,
the same on the card as on the CPU.
"""
from __future__ import annotations

from ..base import register_model
from .comirec import ComirecDR


@register_model("MIND")
class MIND(ComirecDR):
    bilinear_type = 0
