"""Export a ranking model for serving: ``export_program``, the counterpart
of the JAX package's ``export_stablehlo``.

The program is the ranking scorer's eval forward,
``model({"sparse", "dense"}, train=False)["pred"].reshape(-1)``, traced by
``torch.export.export`` and written by ``torch.export.save``.  It takes two
tensors, ``sparse`` int32 ``[B, F]`` and ``dense`` float32 ``[B, Dn]``, and
returns the ``[B]`` probabilities.  The batch dimension is dynamic on both
inputs: the program takes a batch of any number of rows from one up (its
``range_constraints`` say so); the feature counts F and Dn are fixed.

Each embedding table's lookup stays one node of the program, the registered
op ``rec_pangu_tpu_torch::embedding_lookup`` (DeepFM has one, WDL two), so
the loaded program runs the lookup kernel on the card.  Loading needs the
op's registration and nothing else of the package::

    import rec_pangu_tpu_torch  # registers the op
    program = torch.export.load(path)
    probs = program.module()(sparse, dense)

The program does not run the host id check of ``upload_batch``
(``models/base.py``): a fused id outside the table gives a zero row, the
kernel's rule, as the JAX package's export (made without a host plan) does.

A program holds its weights on the device it was exported on.  One exported
on the CPU runs on the card after
``torch.export.passes.move_to_device_pass(program, "cuda")``, and its lookup
then launches the kernel.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import logger
from .scorer import construct_dummy_data


class RankingProgram(nn.Module):
    """The exported function: (sparse [B, F] int32, dense [B, Dn] float32)
    -> [B] probabilities of the wrapped ranking model in eval mode."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, sparse: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        return self.model({"sparse": sparse, "dense": dense}, train=False)["pred"].reshape(-1)


def export_program(model, enc_dict: dict, path: str,
                   device: DeviceLike = None) -> str:
    """Move ``model`` to ``device`` in eval mode, export its scorer with a
    dynamic batch dimension and write the program to ``path``; returns
    ``path``."""
    dev = resolve_device(device)
    model.to(dev).eval()
    dummy = construct_dummy_data(enc_dict)
    args = tuple(torch.from_numpy(dummy[k]).to(dev) for k in ("sparse", "dense"))
    batch = torch.export.Dim("batch", min=1)
    program = torch.export.export(RankingProgram(model), args,
                                  dynamic_shapes=({0: batch}, {0: batch}))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    logger.info(f"torch.export program written to {path} ({os.path.getsize(path)} bytes)")
    return path
