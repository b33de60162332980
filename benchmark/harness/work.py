"""The yardstick's arithmetic: data-sheet peaks and the operations and bytes
each kernel and each whole step or request needs, counted from shapes.

Frozen copies of ``chip_smoke.py``'s ``_BANDWIDTH``, ``_FP32_PEAK``,
``_TF32_PEAK``, ``encoder_work``, ``encoder_bwd_work`` and the byte counts
of its K1 (``phase_kernel``) and K3 (``phase_fused_adam``,
``phase_fused_adam_seq``) rows, so that a later change to the program
cannot move the bounds it is measured against.  Every input byte is counted
read once and every output byte written once.
"""
from __future__ import annotations

from typing import Optional, Tuple

# data-sheet memory bandwidth (bytes/s), float32 rate outside the tensor
# cores and dense TF32 tensor-core rate (FLOP/s), first match on the card's name
BANDWIDTH = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))
FP32_PEAK = (("H100 PCIe", 51e12), ("H100 NVL", 60e12), ("H200", 67e12), ("H100", 67e12))
TF32_PEAK = (("H100 PCIe", 378e12), ("H100 NVL", 417.5e12), ("H200", 495e12),
             ("H100", 495e12))


def peak(table, device_name: str) -> float:
    """The first rate of ``table`` whose key is in ``device_name``."""
    for key, rate in table:
        if key in device_name:
            return rate
    raise ValueError(f"no data-sheet rate known for {device_name!r}")


def packed_floats(dim: int, inner: int, layers: int) -> int:
    """Floats of the encoder's packed weights (q, k, v, output maps with
    biases, the FFN's two maps with biases, two LayerNorms)."""
    return layers * (4 * dim * dim + 4 * dim + 2 * dim * inner + inner + dim + 4 * dim)


def saved_floats(rows: int, dim: int, inner: int) -> int:
    """Floats of one layer's activations the forward saves for K4b over
    ``rows`` = N * L rows."""
    return rows * (8 * dim + inner + 2)


def encoder_work(n: int, length: int, dim: int, inner: int, layers: int) -> Tuple[int, int]:
    """(FLOP, bytes) of the encoder forward (K4f): every product of the
    projections, the full L x L scores and the probabilities times v; x read
    and y written once, the mask and the weights read once."""
    flop = 2 * n * length * layers * (4 * dim * dim + 2 * dim * inner + 2 * length * dim)
    moved = 2 * n * length * dim * 4 + n * length * 4 + packed_floats(dim, inner, layers) * 4
    return flop, moved


def encoder_bwd_work(n: int, length: int, dim: int, inner: int,
                     layers: int) -> Tuple[int, int]:
    """(FLOP, bytes) K4b needs from the saved activations: the weight and the
    input gradients of every projection (twice the forward's products), the
    attention's backward (twice the forward's L x L products) with the scores
    recomputed (half of them again); the saved activations, dy and the mask
    read, dx and the gradients written, the weights read once."""
    proj = 2 * n * length * layers * (4 * dim * dim + 2 * dim * inner)
    attn = 2 * n * length * layers * 2 * length * dim
    flop = 2 * proj + 2 * attn + attn // 2
    moved = ((layers * saved_floats(n * length, dim, inner) + 2 * n * length * dim
              + n * length) * 4 + 2 * packed_floats(dim, inner, layers) * 4)
    return flop, moved


def padded_rows(rows: int) -> int:
    """Rows of the program's table for ``rows`` ids: a multiple of 8,192 from
    65,536 rows on."""
    return -(-rows // 8192) * 8192 if rows >= 64 * 1024 else rows


def lookup_bytes(ids: int, dim: int, fields: int, distinct: Optional[float] = None) -> float:
    """K1: the rows read (each of ``distinct`` rows once where the ids repeat,
    else each id's), each id's row written, the ids and the field offsets
    read."""
    read = ids if distinct is None else distinct
    return read * dim * 4 + ids * dim * 4 + ids * 4 + fields * 4


def adam_bytes(table_rows: int, dim: int, ids: int, dense: bool = False,
               moment_bytes: int = 4) -> int:
    """K3: the table and both moments read and written (Adam moves every row,
    absent ones too), the dense gradient read when there is one, the
    cotangent rows and their ids read."""
    per = 4 + 4 + 2 * 2 * moment_bytes + (4 if dense else 0)
    return table_rows * dim * per + ids * dim * 4 + ids * 4

