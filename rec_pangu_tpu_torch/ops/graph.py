"""Session graphs and NGCF's layer, the JAX package's ``ops/graph.py``:
fixed-shape dense session graphs, the SR-GNN cell and ``NGCFLayer``.

Per history (ids [L], mask [L]) the graph's nodes are its distinct valid
items in ascending order, padded with 0 (``nodes`` [L]); ``alias`` [L]
maps each position to its item's node (a padded position to the rank
past the last item's); the weighted adjacencies ``M_in``, ``M_out`` [L, L]
come from the edges t -> t + 1 between valid positions:
``M_in[j, i] = count(i -> j) / out_degree(i)`` and ``M_out`` the same of
the reversed graph.

* ``host_session_graph`` / ``attach_session_graph``: nodes and alias in
  numpy, on the host, for a training batch (``graph_nodes``,
  ``graph_alias``): the node lookup's ids are then known to the host, so
  the sequence fused step takes them as its ids.
* ``build_session_graph``: the same nodes and alias, and the adjacencies,
  on the device (eval and serving batches carry no graph).
* ``adj_from_alias``: the adjacencies from alias and mask.
* ``take_nodes``: ``hidden[b, alias[b, l]]`` as a one-hot batched product,
  as the JAX package computes it.  Its forward is exact (one nonzero term
  a row); its backward is one more batched product, whose summation order
  is fixed for a shape, so a step gives the same bits every run (a gather's
  backward is a scatter-add of atomics, whose order is not).
* ``SRGNNCell``: the in/out graph convolutions and the GRU-style gate.

The edge counts are small integers, exact in float32 in any summation
order, so host and device graphs agree bit for bit with the JAX package's.

``NGCFLayer`` is NGCF's bipartite message passing: given a node set's
aggregated neighbour messages ``side`` and its own embeddings ``ego``,
``leaky_relu(W1 ego + W1 side + W2 (ego * side), 0.2)``, then dropout
(the hash masks of ``ops/dropout.py``), then ``safe_l2norm``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .dropout import feature_dropout
from .initializers import flax_xavier_normal_
from .numerics import safe_l2norm
from .sequence_enc import _dense, _linear_leaves

_BIG = 2 ** 30  # the sort key of a padded position: after every item id


def adj_from_alias(alias: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """alias [B, L] node ranks, mask [B, L] {0, 1} -> (M_in, M_out [B, L, L])."""
    L = alias.shape[1]
    src = torch.nn.functional.one_hot(alias[:, :-1].long(), L).to(torch.float32)
    dst = torch.nn.functional.one_hot(alias[:, 1:].long(), L).to(torch.float32)
    valid = (mask[:, 1:] * mask[:, :-1]).to(torch.float32)   # edge t -> t+1 iff both valid
    counts = torch.bmm((src * valid[..., None]).transpose(1, 2), dst)   # [B, src, dst]
    out_deg = counts.sum(dim=2, keepdim=True)
    m_in = (counts / out_deg.clamp(min=1.0)).transpose(1, 2)            # [dst, src]
    rev = counts.transpose(1, 2)
    out_deg_rev = rev.sum(dim=2, keepdim=True)
    m_out = (rev / out_deg_rev.clamp(min=1.0)).transpose(1, 2)
    return m_in, m_out


def build_session_graph(hist_item_list: torch.Tensor, hist_mask_list: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, L] ids + mask -> (nodes, alias, M_in, M_out), on their device."""
    ids, mask = hist_item_list, hist_mask_list
    B, L = ids.shape
    key = torch.where(mask > 0, ids.to(torch.int64), _BIG)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    is_new = torch.ones_like(sorted_key, dtype=torch.bool)
    is_new[:, 1:] = sorted_key[:, 1:] != sorted_key[:, :-1]
    rank = torch.cumsum(is_new.to(torch.int64), dim=1) - 1
    values = torch.where(sorted_key < _BIG, sorted_key, 0).to(ids.dtype)
    # positions of one rank carry one value: any write order gives the same nodes
    nodes = torch.zeros_like(ids).scatter(1, rank, values)
    alias = torch.zeros(B, L, dtype=torch.int32, device=ids.device).scatter(
        1, order, rank.to(torch.int32))
    m_in, m_out = adj_from_alias(alias, mask)
    return nodes, alias, m_in, m_out


def host_session_graph(hist_item_list, hist_mask_list) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy nodes and alias [B, L] int32 of ``build_session_graph``."""
    hist = np.asarray(hist_item_list)
    mask = np.asarray(hist_mask_list)
    B, L = hist.shape
    key = np.where(mask > 0, hist.astype(np.int64), _BIG)
    order = np.argsort(key, axis=1, kind="stable")
    sorted_key = np.take_along_axis(key, order, axis=1)
    is_new = np.concatenate(
        [np.ones((B, 1), bool), sorted_key[:, 1:] != sorted_key[:, :-1]], axis=1)
    rank = np.cumsum(is_new, axis=1) - 1
    nodes = np.zeros((B, L), np.int32)
    np.put_along_axis(nodes, rank, np.where(sorted_key < _BIG, sorted_key, 0).astype(np.int32),
                      axis=1)
    alias = np.zeros((B, L), np.int32)
    np.put_along_axis(alias, order, rank.astype(np.int32), axis=1)
    return nodes, alias


def attach_session_graph(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The batch with ``graph_nodes`` and ``graph_alias`` from
    ``host_session_graph`` (a new dict; a batch that holds them already,
    or has no histories, is returned as it is)."""
    if "graph_nodes" in batch or "hist_item_list" not in batch:
        return batch
    nodes, alias = host_session_graph(batch["hist_item_list"], batch["hist_mask_list"])
    return {**batch, "graph_nodes": nodes, "graph_alias": alias}


def take_nodes(hidden: torch.Tensor, alias: torch.Tensor) -> torch.Tensor:
    """hidden [B, S, D] read at alias [B, L] -> [B, L, D], as the one-hot
    product ``bls,bsd->bld`` (see the module's docstring)."""
    onehot = torch.nn.functional.one_hot(alias.long(), hidden.shape[1]).to(hidden.dtype)
    return torch.bmm(onehot, hidden)


class SRGNNCell(nn.Module):
    """SR-GNN's gated cell: ``in_conv`` and ``out_conv`` messages through
    M_in and M_out, then a GRU gate (``lin_ih`` over [in, out], ``lin_hh``
    over the hidden state), every Dense with a fan-in normal kernel and a
    zero bias."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.in_conv = _dense(dim, dim, gen)
        self.out_conv = _dense(dim, dim, gen)
        self.lin_ih = _dense(2 * dim, 3 * dim, gen)
        self.lin_hh = _dense(dim, 3 * dim, gen)

    def forward(self, m_in: torch.Tensor, m_out: torch.Tensor,
                hidden: torch.Tensor) -> torch.Tensor:
        input_in = torch.bmm(m_in, self.in_conv(hidden))
        input_out = torch.bmm(m_out, self.out_conv(hidden))
        gi = self.lin_ih(torch.cat([input_in, input_out], dim=-1))
        gh = self.lin_hh(hidden)
        i_r, i_i, i_n = gi.chunk(3, dim=-1)
        h_r, h_i, h_n = gh.chunk(3, dim=-1)
        reset_gate = torch.sigmoid(i_r + h_r)
        input_gate = torch.sigmoid(i_i + h_i)
        new_gate = torch.tanh(i_n + reset_gate * h_n)
        return (1 - input_gate) * hidden + input_gate * new_gate

    def jax_leaves(self):
        return _linear_leaves(self, ("in_conv", "out_conv", "lin_ih", "lin_hh"))


class NGCFLayer(nn.Module):
    """NGCF's layer (see the module's docstring): ``W1`` and ``W2`` are flax
    ``Dense`` layers with xavier-normal kernels and zero biases, shared by
    the users and the items."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dropout = float(dropout)
        self.W1 = nn.Linear(in_dim, out_dim)
        self.W2 = nn.Linear(in_dim, out_dim)
        for layer in (self.W1, self.W2):
            flax_xavier_normal_(layer.weight, gen)
            nn.init.zeros_(layer.bias)

    def forward(self, side: torch.Tensor, ego: torch.Tensor, train: bool = False,
                seed: int = 0, stream: Tuple[int, int] = (0, 0)) -> torch.Tensor:
        out = torch.nn.functional.leaky_relu(
            self.W1(ego) + self.W1(side) + self.W2(ego * side), negative_slope=0.2)
        if train:
            out = feature_dropout(out, self.dropout, seed, stream)
        return safe_l2norm(out)

    def jax_leaves(self):
        return _linear_leaves(self, ("W1", "W2"))
