from .clrec import CLRec
from .contrarec import ContraRec
from .gru4rec import GRU4Rec
from .iocrec import IOCRec
from .narm import NARM
from .nextitnet import NextItNet
from .sasrec import SASRec
from .srgnn import GCSAN, NISER, SRGNN
from .stamp import STAMP
from .yotubednn import YotubeDNN

__all__ = ["CLRec", "ContraRec", "GCSAN", "GRU4Rec", "IOCRec", "NARM", "NextItNet", "NISER",
           "SASRec", "SRGNN", "STAMP", "YotubeDNN"]
