"""The port's layer library: every name the JAX package's ``ops`` exports."""
from .activations import Dice, get_activation
from .attention import MultiHeadAttention, MultiHeadSelfAttention, scaled_dot_product_attention
from .conv import CCPMConvLayer, MaskedConv1d, NextItNetLayer, ResBlockOneMasked, ResBlockTwoMasked
from .embedding import (FusedEmbedding, ItemEmbedding, LRLayer, check_ids, host_fused_ids,
                        padded_rows)
from .field_graph import FiGNNLayer, GraphLayer
from .graph import NGCFLayer, SRGNNCell, build_session_graph
from .interactions import (
    BilinearInteraction,
    CompressedInteractionNet,
    CrossNet,
    FMLayer,
    HolographicInteraction,
    InteractionMachine,
    MaskBlock,
    SENETLayer,
    inner_product,
)
from .mlp import MLP
from .multi_interest import CapsuleNetwork, MultiInterestSelfAttention
from .numerics import safe_l2norm
from .pooling import kmax_pooling, masked_average_pooling, masked_sum_pooling
from .sequence_enc import (
    BERT4RecEncoder,
    CaserEncoder,
    GRU,
    GRU4RecEncoder,
    STAMPLayer,
    TransformerBlock,
    TransformerEncoder,
)

__all__ = [
    "Dice", "get_activation",
    "MultiHeadAttention", "MultiHeadSelfAttention", "scaled_dot_product_attention",
    "CCPMConvLayer", "MaskedConv1d", "NextItNetLayer", "ResBlockOneMasked",
    "ResBlockTwoMasked",
    "FusedEmbedding", "ItemEmbedding", "LRLayer",
    "FiGNNLayer", "GraphLayer",
    "NGCFLayer", "SRGNNCell", "build_session_graph",
    "BilinearInteraction", "CompressedInteractionNet", "CrossNet", "FMLayer",
    "HolographicInteraction", "InteractionMachine", "MaskBlock", "SENETLayer",
    "inner_product",
    "MLP",
    "CapsuleNetwork", "MultiInterestSelfAttention",
    "safe_l2norm",
    "kmax_pooling", "masked_average_pooling", "masked_sum_pooling",
    "BERT4RecEncoder", "CaserEncoder", "GRU", "GRU4RecEncoder", "STAMPLayer",
    "TransformerBlock", "TransformerEncoder",
    # the port's own, beside the JAX package's names
    "check_ids", "host_fused_ids", "padded_rows",
]
