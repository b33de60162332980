from .clrec import CLRec
from .contrarec import ContraRec
from .iocrec import IOCRec
from .sasrec import SASRec

__all__ = ["CLRec", "ContraRec", "IOCRec", "SASRec"]
