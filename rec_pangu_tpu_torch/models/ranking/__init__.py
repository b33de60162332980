from .afm import AFM
from .afn import AFN
from .aoanet import AOANet
from .autoint import AutoInt
from .ccpm import CCPM
from .dcn import DCN
from .deepfm import DeepFM
from .fibinet import FiBiNet
from .fm import FM
from .lr import LR
from .masknet import MaskNet
from .nfm import NFM
from .wdl import WDL
from .xdeepfm import xDeepFM

__all__ = ["AFM", "AFN", "AOANet", "AutoInt", "CCPM", "DCN", "DeepFM", "FiBiNet", "FM", "LR",
           "MaskNet", "NFM", "WDL", "xDeepFM"]
