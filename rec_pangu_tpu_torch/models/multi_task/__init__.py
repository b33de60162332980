from .aitm import AITM
from .essm import ESSM
from .mlmmoe import MLMMOE
from .mmoe import MMOE
from .omoe import OMOE
from .sharebottom import ShareBottom

__all__ = ["AITM", "ESSM", "MLMMOE", "MMOE", "OMOE", "ShareBottom"]
