from .deepfm import DeepFM

__all__ = ["DeepFM"]
