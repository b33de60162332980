from .activations import get_activation
from .embedding import (FusedEmbedding, ItemEmbedding, check_ids, host_fused_ids,
                        padded_rows)
from .interactions import inner_product
from .mlp import MLP

__all__ = ["get_activation", "FusedEmbedding", "ItemEmbedding", "check_ids", "host_fused_ids",
           "padded_rows", "inner_product", "MLP"]
