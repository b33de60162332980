"""Dropout by counter-hash masks: the same elements on the card and the CPU.

A train step draws one seed a step (``draw_seed``, from the trainer's
generator seeded by ``fit``'s ``seed``) and hands it to the model's forward;
a resumed ``fit`` first skips the seeds of the steps already taken
(``skip_seeds``), so it draws what the uninterrupted run would.
Each dropout site draws its mask from the fused encoder's hash
(``kernels/fused_encoder.dropout_scale``) of (seed, sample, stream,
element), on a stream (layer, site) of its own, so no two sites of a model
drop the same elements and the masks do not depend on the device.

Streams: the transformer's layers use (layer, 0-2); IOCRec's global
attention (256, 0-1); the classic sequence models (257, 0-2) and (258, 0),
NISER's item dropout (258, 1), CMI's (258, 2) (``sequence_enc``); the ranking and
multi-task families from ``MLP_DROPOUT_LAYER`` up: an ``MLP`` (a multi-task
``TaskTower`` too) with stream ``s`` draws layer i's mask on (512 + 16 s +
i, 0), the attention of ``ops/attention.py`` on (``ATTENTION_DROPOUT_LAYER``
+ its block, 0-1), AFM's on (``AFM_DROPOUT``) and AITM's info dropout on
(``AITM_INFO_DROPOUT``); NGCF's layer i on (``NGCF_DROPOUT_LAYER`` + i, 0)
for the users and (..., 1) for the items.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .kernels.fused_encoder import dropout_scale

_SEED_RANGE = 2 ** 31 - 1  # a step's dropout seed lies in [0, 2**31 - 1), as in JAX
MLP_DROPOUT_LAYER = 512
MLP_STREAM_LAYERS = 16      # hidden layers an MLP's streams leave room for
ATTENTION_DROPOUT_LAYER = 1024
AFM_DROPOUT = (1536, 0)
AITM_INFO_DROPOUT = (1537, 0)
NGCF_DROPOUT_LAYER = 1600


def draw_seed(generator: torch.Generator = None) -> int:
    """One dropout seed from ``generator`` (torch's default one when None)."""
    return int(torch.randint(0, _SEED_RANGE, (1,), generator=generator)[0])


def skip_seeds(generator: torch.Generator, n: int) -> None:
    """Advance ``generator`` past ``n`` ``draw_seed`` calls (a resumed
    ``fit`` then draws the seeds of the steps after the restored ones).
    A draw of many seeds advances the CPU generator as as many single
    draws do."""
    while n > 0:
        k = min(int(n), 1 << 16)
        torch.randint(0, _SEED_RANGE, (k,), generator=generator)
        n -= k


class RowSeed(int):
    """A step's dropout seed that also carries ``first_row``, the global
    batch row of the block's first sample, and ``batch_rows``, the global
    batch's rows: under a mesh each ``data`` rank runs its own block of the
    batch, and ``feature_dropout`` and the encoder kernels hash sample i of
    the block as row ``first_row + i``, so the ranks draw the masks the
    single-device step draws on the whole batch (the JAX package folds the
    shard index into its key instead).  A model that stacks views of the
    batch ([hist; aug1; aug2], IOCRec) hashes view v's block at ``v *
    batch_rows + first_row`` (``view_seeds``).  Arithmetic on it gives a
    plain int."""

    def __new__(cls, seed: int, first_row: int = 0, batch_rows: int = 0):
        obj = super().__new__(cls, seed)
        obj.first_row = int(first_row)
        obj.batch_rows = int(batch_rows)
        return obj


def step_seed(seed: Optional[int]) -> int:
    """A forward's dropout seed: ``draw_seed()`` for None, a ``RowSeed`` as
    it is (its rows kept), any other value as an int."""
    if seed is None:
        return draw_seed()
    return seed if isinstance(seed, RowSeed) else int(seed)


def view_seeds(seed: int, views: int) -> Optional[List[RowSeed]]:
    """The seeds of ``views`` stacked views of a block's rows, view v at
    global row ``v * batch_rows + first_row``, as the single-device step
    hashes the stacked whole batch; None for a seed that is no ``RowSeed``
    (the whole batch: one call over the stack draws the same masks)."""
    if not isinstance(seed, RowSeed):
        return None
    return [RowSeed(int(seed), v * seed.batch_rows + seed.first_row, seed.batch_rows)
            for v in range(views)]


def feature_dropout(x: torch.Tensor, rate: float, seed: int, stream: Tuple[int, int]
                    ) -> torch.Tensor:
    """Inverted dropout of x [n, ...] at ``rate`` with the fused encoder's
    hash masks of ``stream`` (layer, site) for ``seed``: the same elements
    on the card and the CPU.  Sample i draws the mask of row i, or of row
    ``seed.first_row + i`` for a ``RowSeed``."""
    if rate <= 0:
        return x
    layer, site = stream
    return x * dropout_scale(seed, x.shape[0], layer, site, tuple(x.shape[1:]), rate, x.device,
                             getattr(seed, "first_row", 0))


def mlp_stream(stream: int, layer: int) -> Tuple[int, int]:
    """The dropout stream of hidden layer ``layer`` of the MLP with stream
    ``stream``."""
    if not 0 <= layer < MLP_STREAM_LAYERS:
        raise ValueError(f"an MLP's dropout streams hold {MLP_STREAM_LAYERS} layers, "
                         f"got layer {layer}")
    return (MLP_DROPOUT_LAYER + MLP_STREAM_LAYERS * int(stream) + layer, 0)
