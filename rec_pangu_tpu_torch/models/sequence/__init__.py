from .iocrec import IOCRec
from .sasrec import SASRec

__all__ = ["IOCRec", "SASRec"]
