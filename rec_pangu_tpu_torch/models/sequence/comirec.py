"""ComiRec-SA and ComiRec-DR: K interests of the history, by self-attention
(SA) or by the capsule network with per-position weights (DR).

The JAX package's ``models/sequence/comirec.py``, its weights under the same
flax names (``multi_interest_sa/W1``, ``W2``; ``capsule/w``).  In training
the interest with the largest inner product with the target item
(``best_interest``) goes into the full-softmax CE.  That target read feeds
only an argmax, which has no gradient, so it is made on the table without
autograd (``target_rows``), outside the fused step's capture: the fused step
sees the history lookup and the CE alone.  On the card both reads are K1.
"""
from __future__ import annotations

import torch

from ...ops.embedding import ItemEmbedding
from ...ops.multi_interest import CapsuleNetwork, MultiInterestSelfAttention
from ..base import SequenceModelBase, register_model


def best_interest(interests: torch.Tensor, item_e: torch.Tensor) -> torch.Tensor:
    """[B, K, D], [B, D] -> the interest with the largest inner product with
    the item [B, D]; ties go to the lowest k, as with ``jnp.argmax``."""
    k = torch.matmul(interests, item_e[:, :, None])[..., 0].argmax(dim=1)
    return interests[torch.arange(interests.shape[0], device=interests.device), k]


def target_rows(item_emb: ItemEmbedding, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``ids`` read without autograd (the lookup kernel on the
    card): for ``best_interest``'s argmax only."""
    with torch.no_grad():
        return item_emb(ids)


class _MultiInterestModel(SequenceModelBase):
    """The history's K interests; in training the best one for the target
    item through the full-softmax CE.  Children build their extraction
    layer and call it in ``interests``."""

    fused_update_compatible = True

    def interests(self, seq_emb, mask, batch, train, seed):
        raise NotImplementedError

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...], "ce": [...]} lists;
        ``seed``: the step's seed (see SequenceModelBase)."""
        capture = capture or {}
        seq_emb = self.item_emb(batch["hist_item_list"], capture.get("hist"))
        interests = self.interests(seq_emb, batch["hist_mask_list"], batch, train, seed)
        out = {"user_emb": interests}
        if train:
            item = batch["target_item"]
            best = best_interest(interests, target_rows(self.item_emb, item))
            out["loss"] = self.calculate_loss(best, item, capture.get("ce"), seed)
        return out


@register_model("ComirecSA")
class ComirecSA(_MultiInterestModel):
    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        self.multi_interest_sa = MultiInterestSelfAttention(
            self.embedding_dim, int(self.config["K"]), generator=self.generator)

    def interests(self, seq_emb, mask, batch, train, seed):
        return self.multi_interest_sa(seq_emb, mask)

    def jax_leaves(self):
        return ([(c, ("item_emb",) + p, t, tr) for c, p, t, tr in self.item_emb.jax_leaves()]
                + [(c, ("multi_interest_sa",) + p, t, tr)
                   for c, p, t, tr in self.multi_interest_sa.jax_leaves()])


@register_model("ComirecDR")
class ComirecDR(_MultiInterestModel):
    bilinear_type = 2

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        self.capsule = CapsuleNetwork(self.embedding_dim, self.max_length,
                                      bilinear_type=self.bilinear_type,
                                      interest_num=int(self.config["K"]),
                                      generator=self.generator)

    def interests(self, seq_emb, mask, batch, train, seed):
        return self.capsule(seq_emb, mask, batch.get("routing_logits"),
                            seed if train else None)

    def jax_leaves(self):
        return ([(c, ("item_emb",) + p, t, tr) for c, p, t, tr in self.item_emb.jax_leaves()]
                + [(c, ("capsule",) + p, t, tr) for c, p, t, tr in self.capsule.jax_leaves()])
