from .clrec import CLRec
from .cmi import CMI
from .comirec import ComirecDR, ComirecSA
from .contrarec import ContraRec
from .gru4rec import GRU4Rec
from .iocrec import IOCRec
from .mind import MIND
from .narm import NARM
from .nextitnet import NextItNet
from .re4 import Re4
from .sasrec import SASRec
from .sine import SINE
from .srgnn import GCSAN, NISER, SRGNN
from .stamp import STAMP
from .yotubednn import YotubeDNN

__all__ = ["CLRec", "CMI", "ComirecDR", "ComirecSA", "ContraRec", "GCSAN", "GRU4Rec", "IOCRec",
           "MIND", "NARM", "NextItNet", "NISER", "Re4", "SASRec", "SINE", "SRGNN", "STAMP",
           "YotubeDNN"]
