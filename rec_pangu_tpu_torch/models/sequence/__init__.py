from .sasrec import SASRec

__all__ = ["SASRec"]
