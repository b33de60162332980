from .ckpt import load_checkpoint, save_checkpoint
from .trainer import RankTrainer

__all__ = ["RankTrainer", "load_checkpoint", "save_checkpoint"]
