"""ContraRec: a sequence encoder (BERT4Rec by default, or GRU4Rec's or
Caser's: ``encoder_name``) over a history and two augmented views of it,
the full-softmax CE and a supervised contrastive loss between the views
(positives: views whose histories share a target item).

The JAX package's ``models/sequence/contrarec.py``, its weights under the
same flax names (``jax_leaves``).  A training batch either carries the
views from the host, ``aug_all = [hist; aug1; aug2]`` [3B, L] (the trainer
builds it, ``host_aug``), which the sequence fused step captures; or it
does not, and the forward draws the two views on the device
(``augment.augment_sequences``) from a generator seeded by the step's
seed.  Either way one ``[3B, L]`` lookup and one ``[3B]`` encoder pass
serve the history and both views: every encoder op is batch-parallel, so
the rows are those of separate passes.  On the card the lookup is K1 and
the BERT4Rec encoder K4f (K4b backward; the GRU4Rec and Caser encoders are
plain torch, ``GRU4RecEncoder(hidden_size=128)`` and ``CaserEncoder(
max_length, 16, 8, 5)`` as in the JAX package); the device-view lookup is
not captured, so its backward is the table gradient kernel over the 3BL
sorted ids (``embedding_grad.sorted_segment_accumulate``, K7's
counterpart).
"""
from __future__ import annotations

import torch

from ...ops.numerics import safe_l2norm
from ...ops.sequence_enc import BERT4RecEncoder, CaserEncoder, GRU4RecEncoder, step_seed
from ..base import SequenceModelBase, register_model
from .augment import augment_sequences
from .contra_losses import contrarec_contra_loss


@register_model("ContraRec")
class ContraRec(SequenceModelBase):
    fused_update_compatible = True
    host_aug = True               # the trainer builds batch["aug_all"] on the host
    fused_lookup_key = "aug_all"  # the ids of the fused step's captured rows

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        cfg = self.config
        self.gamma = float(cfg.get("gamma", 1))
        self.beta_a = float(cfg.get("beta_a", 3))
        self.beta_b = float(cfg.get("beta_b", 3))
        self.ccc_temp = float(cfg.get("ccc_temp", 0.2))
        self.encoder_name = cfg.get("encoder_name", "BERT4Rec")
        D, gen = self.embedding_dim, self.generator
        if self.encoder_name == "GRU4Rec":
            self.encoder = GRU4RecEncoder(D, hidden_size=128, generator=gen)
        elif self.encoder_name == "Caser":
            self.encoder = CaserEncoder(self.max_length, D, num_horizon=16, num_vertical=8,
                                        l=5, generator=gen)
        elif self.encoder_name == "BERT4Rec":
            self.encoder = BERT4RecEncoder(self.max_length, D, num_layers=2, num_heads=2,
                                           generator=gen)
        else:
            raise ValueError(f"Invalid sequence encoder {self.encoder_name!r}")
        # the last id is the mask token: a real item, as in the reference
        self.mask_token = int(enc_dict[cfg.get("item_col", "item_id")]["vocab_size"]) - 1

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...], "ce": [...]} lists;
        ``seed``: the step's seed, which also seeds the device views of a
        training batch without ``aug_all``."""
        item_seq = batch["hist_item_list"]
        lengths = batch["hist_mask_list"].sum(dim=-1).to(torch.int64)
        B = item_seq.shape[0]
        capture = capture or {}
        if not train:
            return {"user_emb": self._encode(self.item_emb(item_seq, capture.get("hist")),
                                             lengths, False)}
        seed = step_seed(seed)
        all_seq = batch.get("aug_all")
        if all_seq is None:
            gen = torch.Generator(device=item_seq.device).manual_seed(seed + 2)
            views = [augment_sequences(gen, item_seq, self.beta_a, self.beta_b,
                                       self.mask_token) for _ in range(2)]
            all_seq = torch.cat([item_seq] + views, dim=0)
        enc = self._encode(self.item_emb(all_seq, capture.get("hist")), lengths.repeat(3), True)
        user_emb = enc[:B]
        item = batch["target_item"]
        features = safe_l2norm(torch.stack([enc[B:2 * B], enc[2 * B:]], dim=1))
        loss = (self.calculate_loss(user_emb, item, capture.get("ce"), seed)
                + self.gamma * contrarec_contra_loss(self.global_rows(features),
                                                     self.global_rows(item), self.ccc_temp))
        return {"user_emb": user_emb, "loss": loss}

    def _encode(self, seq_emb: torch.Tensor, lengths: torch.Tensor, train: bool) -> torch.Tensor:
        if self.encoder_name == "BERT4Rec":
            return self.encoder(seq_emb, lengths, train)
        return self.encoder(seq_emb, lengths)

    def jax_leaves(self):
        return ([(c, ("item_emb",) + p, t, tr) for c, p, t, tr in self.item_emb.jax_leaves()]
                + [(c, ("encoder",) + p, t, tr) for c, p, t, tr in self.encoder.jax_leaves()])
