"""The one place where an entry point's ``device`` argument is resolved,
and the card's memory in use (``get_device_usage``).

``None`` means the CUDA card.  Where CUDA is absent that raises instead of
quietly running on the CPU: a caller who wants the CPU asks for it
(``device="cpu"``), as the tests do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default when device=None) "
            f"but CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def get_device_usage(device: DeviceLike = None) -> str:
    """The card's memory in use and its size, ``"used G/total G"`` from
    ``torch.cuda.mem_get_info`` (what every process holds, as the
    reference's ``get_gpu_usage`` reads it); ``"n/a"`` for the CPU or
    without CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "n/a"
    free, total = torch.cuda.mem_get_info(dev)
    return f"{(total - free) / 1024 ** 3:.2f} G/{total / 1024 ** 3:.2f} G"
