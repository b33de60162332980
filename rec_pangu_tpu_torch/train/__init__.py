from .ckpt import load_checkpoint, save_checkpoint
from .trainer import RankTrainer, SequenceTrainer

__all__ = ["RankTrainer", "SequenceTrainer", "load_checkpoint", "save_checkpoint"]
