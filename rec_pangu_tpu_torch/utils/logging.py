"""The port's logger and an optional wandb, as the JAX package's
``utils/logging.py``.

``logger`` is the ``rec_pangu_tpu_torch`` logger with a stderr handler at
INFO.  ``wandb`` is the real package when it is installed (``HAS_WANDB``),
else a stand-in whose ``init``, ``log``, ``login`` and ``finish`` do
nothing.
"""
from __future__ import annotations

import logging
import sys

logger = logging.getLogger("rec_pangu_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter(
        "%(asctime)s | %(levelname)s | %(name)s - %(message)s", "%Y-%m-%d %H:%M:%S"))
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)

try:  # pragma: no cover - depends on the environment
    import wandb  # type: ignore

    HAS_WANDB = True
except ImportError:  # pragma: no cover
    HAS_WANDB = False

    class _NoopWandb:
        def init(self, *args, **kwargs):
            return None

        def login(self, *args, **kwargs):
            return None

        def log(self, *args, **kwargs):
            return None

        def finish(self, *args, **kwargs):
            return None

    wandb = _NoopWandb()  # type: ignore
