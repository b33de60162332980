"""Plain SASRec (Kang and McAuley, ICDM 2018, at RecBole's SASRec.yaml) as
the configuration states it: training with the full-softmax CE and dense
Adam, and retrieval of each user's top-k of the corpus.

The model: history ids [B, L] (0 = padding, ids placed first) index the
item table, padded positions read zero; a stack of post-LN transformer
blocks (per block: q, k, v linear maps split into heads, scores divided by
sqrt(head size), -1e6 added where a key is padding or in the query's
future, softmax, dropout on the probabilities, the output map, dropout, a
residual and LayerNorm; then linear, tanh-form GELU, linear, dropout, a
residual and LayerNorm); the user embedding is the output at the history's
last valid position (position 0 for an empty one).  No position embedding
and no input LayerNorm: the configuration's file lists the departures.
Dropout is inverted, with the counter-hash masks of ``common``: layer l's
sites are (l, 0) the probabilities [heads, L, L], (l, 1) the attention
output [L, D] and (l, 2) the FFN output [L, D].

The loss is mean_b[logsumexp_v(u_b . item_v) - u_b . item_{target_b}] over
the vocabulary's ids 0..V-1, item 0's logit pinned to 0 (it counts in the
denominator and gets no gradient).  Retrieval scores the L2-normalized
users against the L2-normalized rows 0..V-1 of the table with row 0
zeroed.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import Adam, dropout_factors, norms

_PAD_FROM, _PAD_TO = 64 * 1024, 8192
_NEG = -1e6
CE_ROWS = 512  # users whose [rows, V] logits the CE holds at once
LINEARS = ("query", "key", "value", "dense")


def table_rows(config: dict) -> int:
    v = int(config["vocab_size"])
    return -(-v // _PAD_TO) * _PAD_TO if v >= _PAD_FROM else v


def _block(i: int) -> str:
    return f"self_attention.blocks.{i}"


def weight_specs(config: dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(name, shape, mean, std) of every weight, in the order they are drawn."""
    m = config["model_config"]
    D, inner = int(m["embedding_dim"]), int(m["inner_size"])
    std = float(config["init"]["std"])
    specs = [("item_emb.table", (table_rows(config), D), 0.0, std)]
    for i in range(int(m["n_layers"])):
        b = _block(i)
        for name in LINEARS:
            specs += [(f"{b}.{name}.weight", (D, D), 0.0, std),
                      (f"{b}.{name}.bias", (D,), 0.0, std)]
        specs += [(f"{b}.ffn_1.weight", (inner, D), 0.0, std),
                  (f"{b}.ffn_1.bias", (inner,), 0.0, std),
                  (f"{b}.ffn_2.weight", (D, inner), 0.0, std),
                  (f"{b}.ffn_2.bias", (D,), 0.0, std)]
        for ln in ("LayerNorm_0", "LayerNorm_1"):
            specs += [(f"{b}.{ln}.weight", (D,), 1.0, std), (f"{b}.{ln}.bias", (D,), 0.0, std)]
    return specs


def encode(weights: Dict[str, torch.Tensor], config: dict, hist: torch.Tensor,
           mask: torch.Tensor, train: bool, seed: int = 0) -> torch.Tensor:
    """User embeddings [B, D] of histories [B, L] (int64) with masks [B, L]."""
    m = config["model_config"]
    table = weights["item_emb.table"]
    B, L = hist.shape
    D, H = int(m["embedding_dim"]), int(m["n_heads"])
    eps = float(m["layer_norm_eps"])
    p_hidden = float(m["hidden_dropout_prob"]) if train else 0.0
    p_attn = float(m["attn_dropout_prob"]) if train else 0.0
    x = table[hist] * (hist != 0).unsqueeze(-1)
    ok = (mask != 0)[:, None, None, :] & torch.ones(L, L, dtype=torch.bool,
                                                      device=hist.device).tril()
    add_mask = torch.where(ok, 0.0, _NEG).to(torch.float32)
    sqrt_dh = float(np.sqrt(np.float32(D // H)))
    for i in range(int(m["n_layers"])):
        b = _block(i)

        def lin(name, t):
            return F.linear(t, weights[f"{b}.{name}.weight"], weights[f"{b}.{name}.bias"])

        q, k, v = (lin(n, x).view(B, L, H, D // H) for n in ("query", "key", "value"))
        probs = torch.softmax(torch.einsum("blhd,bmhd->bhlm", q, k) / sqrt_dh + add_mask, dim=-1)
        if p_attn > 0:
            probs = probs * dropout_factors(seed, B, i, 0, (H, L, L), p_attn, hist.device)
        a = lin("dense", torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(B, L, D))
        if p_hidden > 0:
            a = a * dropout_factors(seed, B, i, 1, (L, D), p_hidden, hist.device)
        x = F.layer_norm(a + x, (D,), weights[f"{b}.LayerNorm_0.weight"],
                         weights[f"{b}.LayerNorm_0.bias"], eps)
        f = lin("ffn_2", F.gelu(lin("ffn_1", x), approximate="tanh"))
        if p_hidden > 0:
            f = f * dropout_factors(seed, B, i, 2, (L, D), p_hidden, hist.device)
        x = F.layer_norm(f + x, (D,), weights[f"{b}.LayerNorm_1.weight"],
                         weights[f"{b}.LayerNorm_1.bias"], eps)
    last = (mask.sum(dim=-1).to(torch.int64) - 1).clamp(min=0)
    return x[torch.arange(B, device=hist.device), last]


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    out = {"hist": torch.from_numpy(np.asarray(batch["hist_item_list"], np.int64)).to(device),
           "mask": torch.from_numpy(np.asarray(batch["hist_mask_list"], np.float32)).to(device)}
    if "target_item" in batch:
        out["target"] = torch.from_numpy(np.asarray(batch["target_item"], np.int64)).to(device)
    return out


def _ce_grads(user: torch.Tensor, table: torch.Tensor, target: torch.Tensor, vocab: int):
    """(loss, d loss / d user, d loss / d table) of the full-softmax CE, its
    logits held CE_ROWS users at a time."""
    B = user.shape[0]
    items = table.detach()[:vocab].clone().requires_grad_(True)
    d_user = torch.empty_like(user)
    total = torch.zeros((), dtype=torch.float64, device=user.device)
    for lo in range(0, B, CE_ROWS):
        u = user.detach()[lo:lo + CE_ROWS].clone().requires_grad_(True)
        logits = (u @ items.T).index_fill(1, torch.zeros(1, dtype=torch.int64,
                                                         device=u.device), 0.0)
        part = F.cross_entropy(logits, target[lo:lo + CE_ROWS], reduction="sum") / B
        part.backward()
        total += part.detach().double()
        d_user[lo:lo + CE_ROWS] = u.grad
        del logits, part
    d_table = torch.zeros_like(table)
    d_table[:vocab] = items.grad
    return float(total), d_user, d_table


def train_steps(config: dict, weights: Dict[str, torch.Tensor],
                batches: Sequence[Dict[str, np.ndarray]], seeds: Sequence[int], device) -> dict:
    """Train ``weights`` (changed in place) with dense Adam at the
    configuration's rate, one step a batch with that step's dropout seed.
    Returns each step's loss, every leaf's first gradient norm and every
    leaf's norm of change after the last step."""
    vocab = int(config["vocab_size"])
    start = {k: t.clone() for k, t in weights.items()}
    params = {k: t.requires_grad_(True) for k, t in weights.items()}
    opt = Adam(params, float(config["lr"]))
    losses, first = [], None
    for batch, seed in zip(batches, seeds):
        inputs = to_device(batch, device)
        user = encode(params, config, inputs["hist"], inputs["mask"], True, seed)
        value, d_user, d_table = _ce_grads(user, params["item_emb.table"], inputs["target"],
                                           vocab)
        got = torch.autograd.grad(user, list(params.values()), d_user, allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), got)}
        grads["item_emb.table"] = grads["item_emb.table"] + d_table
        if first is None:
            first = norms(grads)
        losses.append(value)
        opt.step(grads)
        del grads, d_user, d_table, user
    change = norms({k: params[k].detach() - start[k] for k in params})
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def corpus(weights: Dict[str, torch.Tensor], config: dict, normalize: bool) -> torch.Tensor:
    """Rows 0..V-1 of the table, row 0 zeroed, L2-normalized when asked."""
    vocab = int(config["vocab_size"])
    items = weights["item_emb.table"][:vocab].clone()
    items[0] = 0.0
    return _normalize(items) if normalize else items


@torch.no_grad()
def scores(weights: Dict[str, torch.Tensor], config: dict, items: torch.Tensor,
           batch: Dict[str, np.ndarray], normalize: bool, device) -> torch.Tensor:
    """[B, V] scores of a request's users against the corpus ``items``."""
    inputs = to_device(batch, device)
    user = encode(weights, config, inputs["hist"], inputs["mask"], False)
    if normalize:
        user = _normalize(user)
    return user @ items.T
