from .benchmark import BenchmarkTrainer
from .ckpt import load_checkpoint, save_checkpoint
from .trainer import GraphTrainer, RankTrainer, SequenceTrainer

__all__ = ["BenchmarkTrainer", "GraphTrainer", "RankTrainer", "SequenceTrainer",
           "load_checkpoint", "save_checkpoint"]
