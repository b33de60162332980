from .ngcf import NGCF

__all__ = ["NGCF"]
