from .base import (MODEL_REGISTRY, RankModelBase, SequenceModelBase, get_model,
                   register_model)
from .graph import *  # noqa: F401,F403
from .losses import get_loss_fn
from .multi_task import *  # noqa: F401,F403
from .ranking import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403

__all__ = ["MODEL_REGISTRY", "RankModelBase", "SequenceModelBase", "get_model",
           "register_model", "get_loss_fn"]
