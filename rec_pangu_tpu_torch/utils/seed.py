"""Seeding of the host's and torch's global generators, as the reference's
``seed_everything`` (the JAX package's seeds the host ones only).

The port's own randomness takes explicit generators (a model's ``seed``,
``fit``'s ``seed``); this covers code that draws from the global ones.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 1029) -> None:
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # every device's default generator too
