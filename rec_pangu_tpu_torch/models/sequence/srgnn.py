"""SRGNN, GCSAN and NISER: session-graph models.

Each history becomes a session graph (``ops/graph.py``): its distinct items
are the nodes, looked up once in the item table, then ``step`` SR-GNN cells
pass messages along the session's transitions, and ``take_nodes`` reads
the nodes back at the history's positions.

* SRGNN: an attention readout (``_SRGNNReadout``) over the positions and
  the last one.
* GCSAN: the causal transformer encoder (``TransformerEncoder``, gelu, eps
  1e-3; on the card K4f, and K4b in training) over the GNN output, its
  last position blended with the GNN's by ``weight``.
* NISER: dropout on the node embeddings (``NISER_ITEM_DROPOUT``), L2-normed
  nodes, a learned position table ``pos_embedding`` [max_length, D], the
  readout, L2-normed.

``_graph_parts`` takes the host graph when the batch holds ``graph_nodes``
(``SequenceTrainer`` attaches it to every training batch, so the sequence
fused step's ids are the nodes: ``fused_lookup_key``) and otherwise builds
the graph on the device (serving, ``evaluate_model``).  The JAX package's
``models/sequence/srgnn.py``, its weights under the same flax names.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ...convert import prefixed
from ...ops.embedding import check_item_ids
from ...ops.graph import SRGNNCell, adj_from_alias, build_session_graph, take_nodes
from ...ops.initializers import flax_fan_in_normal_
from ...ops.kernels.fused_encoder import check_rate
from ...ops.numerics import safe_l2norm
from ...ops.sequence_enc import (NISER_ITEM_DROPOUT, TransformerEncoder, _dense,
                                 _linear_leaves, draw_seed, feature_dropout)
from ..base import SequenceModelBase, register_model


class _SRGNNReadout(nn.Module):
    """alpha = linear_three(sigmoid(linear_one(ht) + linear_two(h)));
    session = linear_transform([sum(alpha * h * mask); ht])."""

    def __init__(self, dim: int, generator: torch.Generator):
        super().__init__()
        self.linear_one = _dense(dim, dim, generator)
        self.linear_two = _dense(dim, dim, generator)
        self.linear_three = _dense(dim, 1, generator, bias=False)
        self.linear_transform = _dense(2 * dim, dim, generator)

    def forward(self, seq_hidden: torch.Tensor, ht: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        q1 = self.linear_one(ht)[:, None, :]
        alpha = self.linear_three(torch.sigmoid(q1 + self.linear_two(seq_hidden)))
        a = (alpha * seq_hidden * mask[..., None]).sum(dim=1)
        return self.linear_transform(torch.cat([a, ht], dim=1))

    def jax_leaves(self):
        return _linear_leaves(self, ("linear_one", "linear_two", "linear_three",
                                     "linear_transform"))


@register_model("SRGNN")
class SRGNN(SequenceModelBase):
    session_graph = True
    fused_update_compatible = True
    fused_lookup_key = "graph_nodes"
    readout_used = True

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        self.step = int(self.config.get("step", 1))
        self.gnncell = SRGNNCell(self.embedding_dim, self.generator)
        if self.readout_used:
            self.readout = _SRGNNReadout(self.embedding_dim, self.generator)

    def _graph_parts(self, batch):
        """(nodes, alias, M_in, M_out): the host graph's nodes and alias when
        the batch holds them, else the graph built on the device."""
        mask = batch["hist_mask_list"]
        if "graph_nodes" in batch:
            alias = batch["graph_alias"]
            return (batch["graph_nodes"], alias) + adj_from_alias(alias, mask)
        return build_session_graph(batch["hist_item_list"], mask)

    def _gnn(self, hidden, m_in, m_out):
        for _ in range(self.step):
            hidden = self.gnncell(m_in, m_out, hidden)
        return hidden

    def _gnn_seq_hidden(self, batch, capture):
        nodes, alias, m_in, m_out = self._graph_parts(batch)
        hidden = self._gnn(self.item_emb(nodes, capture.get("hist")), m_in, m_out)
        return take_nodes(hidden, alias)

    @staticmethod
    def _last(mask: torch.Tensor) -> torch.Tensor:
        return (mask.sum(dim=-1).to(torch.int64) - 1).clamp(min=0)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        """``capture``: the fused step's {"hist": [...], "ce": [...]} lists
        (the node lookup's rows); ``seed``: the step's seed."""
        capture = capture or {}
        mask = batch["hist_mask_list"]
        seq_hidden = self._gnn_seq_hidden(batch, capture)
        ht = self.gather_indexes(seq_hidden, self._last(mask))
        return self._outputs(self.readout(seq_hidden, ht, mask), batch, train, capture, seed)

    def _outputs(self, user_emb, batch, train, capture, seed):
        out = {"user_emb": user_emb}
        if train:
            out["loss"] = self.calculate_loss(user_emb, batch["target_item"],
                                              capture.get("ce"), seed)
        return out

    def upload_batch(self, batch: Dict[str, np.ndarray], device: torch.device,
                     train: bool = False) -> Dict[str, torch.Tensor]:
        """``SequenceModelBase.upload_batch``, plus the host graph's
        ``graph_nodes`` (item ids, checked) and ``graph_alias`` (node ranks
        in [0, L), checked) when the batch holds them, as int32."""
        out = super().upload_batch(batch, device, train)
        if "graph_nodes" in batch:
            nodes = np.asarray(batch["graph_nodes"])
            alias = np.asarray(batch["graph_alias"])
            check_item_ids(nodes, self.item_emb.vocab_size)
            if alias.size and (int(alias.min()) < 0 or int(alias.max()) >= alias.shape[-1]):
                raise ValueError(f"graph_alias out of range [0, {alias.shape[-1]})")
            for key, arr in (("graph_nodes", nodes), ("graph_alias", alias)):
                out[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(device)
        return out

    def jax_leaves(self):
        leaves = (prefixed("item_emb", self.item_emb.jax_leaves())
                  + prefixed("gnncell", self.gnncell.jax_leaves()))
        if self.readout_used:
            leaves += prefixed("readout", self.readout.jax_leaves())
        return leaves


@register_model("GCSAN")
class GCSAN(SRGNN):
    # the JAX GCSAN never calls the readout it inherits, so it has no weights
    readout_used = False

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        cfg = self.config
        self.weight = float(cfg.get("weight", 0.1))
        self.self_attention = TransformerEncoder(
            self.embedding_dim,
            n_layers=int(cfg.get("n_layers", 2)),
            n_heads=int(cfg.get("n_heads", 4)),
            inner_size=int(cfg.get("inner_size", 32)),
            hidden_dropout_prob=float(cfg.get("hidden_dropout_prob", 0.1)),
            attn_dropout_prob=float(cfg.get("attn_dropout_prob", 0.1)),
            hidden_act=cfg.get("hidden_act", "gelu"),
            layer_norm_eps=float(cfg.get("layer_norm_eps", 0.001)),
            generator=self.generator)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        capture = capture or {}
        mask = batch["hist_mask_list"]
        seq_hidden = self._gnn_seq_hidden(batch, capture)
        idx = self._last(mask)
        ht = self.gather_indexes(seq_hidden, idx)
        output = self.self_attention(seq_hidden, mask, causal=True, train=train, seed=seed)
        at = self.gather_indexes(output, idx)
        user_emb = self.weight * at + (1 - self.weight) * ht
        return self._outputs(user_emb, batch, train, capture, seed)

    def jax_leaves(self):
        return super().jax_leaves() + prefixed("self_attention",
                                                self.self_attention.jax_leaves())


@register_model("NISER")
class NISER(SRGNN):
    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.item_dropout = float(self.config.get("item_dropout", 0.1))
        check_rate(self.item_dropout)
        self.pos_embedding = nn.Parameter(torch.empty(self.max_length, self.embedding_dim))
        flax_fan_in_normal_(self.pos_embedding, self.generator)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        capture = capture or {}
        if train and seed is None:
            seed = draw_seed()
        mask = batch["hist_mask_list"]
        nodes, alias, m_in, m_out = self._graph_parts(batch)
        hidden = self.item_emb(nodes, capture.get("hist"))
        if train:
            hidden = feature_dropout(hidden, self.item_dropout, seed, NISER_ITEM_DROPOUT)
        hidden = self._gnn(safe_l2norm(hidden), m_in, m_out)
        seq_hidden = take_nodes(hidden, alias)
        seq_hidden = seq_hidden + self.pos_embedding[None, :seq_hidden.shape[1]]
        ht = self.gather_indexes(seq_hidden, self._last(mask))
        user_emb = safe_l2norm(self.readout(seq_hidden, ht, mask))
        return self._outputs(user_emb, batch, train, capture, seed)

    def jax_leaves(self):
        return super().jax_leaves() + [("params", ("pos_embedding",), self.pos_embedding, False)]
