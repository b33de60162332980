"""Sequence-recall models over one item table (``SequenceTrainer``'s family
and ``make_retrieval_scorer``).

A configuration gives ``model`` (a registered sequence model), its
``model_config`` and ``vocab_size`` (ids 1 .. V - 1 are items, 0 is
padding).  A traffic file gives ``batch``, ``pool`` (distinct host batches
or requests made at set-up), ``zipf`` (item ids Zipf over the corpus, hot
ids scattered by a seeded permutation) and ``length_weights``: entry k is
the weight of a history of k + 1 items (max_length entries), its items
first and the padding after them.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import data, work


def enc_dict(config: dict) -> dict:
    return {config["model_config"].get("item_col", "item_id"):
            {"vocab_size": int(config["vocab_size"])}}


def build(config: dict):
    """The program's model, with the constructor's own initial weights."""
    from rec_pangu_tpu_torch.models import get_model

    return get_model(config["model"])(enc_dict=enc_dict(config),
                                      config=dict(config["model_config"]))


def make_trainer(workdir: str, device):
    from rec_pangu_tpu_torch.train.trainer import SequenceTrainer

    return SequenceTrainer(model_ckpt_dir=workdir, device=device)



def _histories(config: dict, traffic: dict, n: int, gen: torch.Generator, targets: bool):
    vocab, length = int(config["vocab_size"]), int(config["model_config"]["max_length"])
    items = data.zipf_ids(vocab - 1, n * length + (n if targets else 0),
                          float(traffic["zipf"]), gen, first=1)
    weights = torch.tensor([float(w) for w in traffic["length_weights"]], device=gen.device)
    if weights.numel() != length:
        raise ValueError(f"length_weights has {weights.numel()} entries, max_length is {length}")
    lengths = torch.multinomial(weights, n, replacement=True, generator=gen) + 1
    mask = torch.arange(length, device=gen.device)[None, :] < lengths[:, None]
    hist = torch.where(mask, items[:n * length].view(n, length), 0).to(torch.int32)
    out = {"hist_item_list": hist, "hist_mask_list": mask.to(torch.float32)}
    if targets:
        out["target_item"] = items[n * length:].to(torch.int32)
    return out


def _pool(config: dict, traffic: dict, seed: int, device, tag: str, targets: bool):
    parts = int(traffic["pool"])
    arrays = _histories(config, traffic, int(traffic["batch"]) * parts,
                        data.generator(seed, tag, device), targets)
    cut = {k: data.split(v, parts) for k, v in arrays.items()}
    return [{k: cut[k][i] for k in cut} for i in range(parts)]


def train_pool(config: dict, traffic: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    return _pool(config, traffic, seed, device, "train_pool", True)


def request_pool(config: dict, traffic: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    return _pool(config, traffic, seed, device, "request_pool", False)


def lookup_ids(config: dict, batch: Dict[str, np.ndarray]) -> np.ndarray:
    """The ids K1 reads for a host batch: the histories' (padding's 0 too)."""
    return np.asarray(batch["hist_item_list"], np.int64).reshape(-1)


def _shape(config: dict):
    m = config["model_config"]
    return (int(m["max_length"]), int(m["embedding_dim"]), int(m["inner_size"]),
            int(m["n_layers"]))



def train_work(config: dict, traffic: dict) -> Dict[str, float]:
    """A training step's work: the encoder's products forward and backward
    (twice the forward; nothing recomputed) and the full-corpus CE's three
    [B, V, D] products; K1's and K3's bytes (with the CE's dense stream);
    K4f's and K4b's operations."""
    batch = int(traffic["batch"])
    L, D, inner, layers = _shape(config)
    fwd = work.encoder_work(batch, L, D, inner, layers)[0]
    ids = batch * L
    return {"flop": 3 * fwd + 6 * batch * int(config["vocab_size"]) * D,
            "k1_ids": ids, "k1_dim": D, "k1_fields": 1,
            "k3_bytes": work.adam_bytes(work.padded_rows(int(config["vocab_size"])), D, ids,
                                        dense=True),
            "k4f_flop": fwd,
            "k4b_flop": work.encoder_bwd_work(batch, L, D, inner, layers)[0]}


def request_work(config: dict, traffic: dict) -> Dict[str, float]:
    """A retrieval request's work: the encoder's products and the [B, V, D]
    scoring product; K1's bytes and K4f's operations."""
    batch = int(traffic["batch"])
    L, D, inner, layers = _shape(config)
    fwd = work.encoder_work(batch, L, D, inner, layers)[0]
    return {"flop": fwd + 2 * batch * int(config["vocab_size"]) * D,
            "k1_ids": batch * L, "k1_dim": D, "k1_fields": 1,
            "k4f_flop": fwd}
