from .dataset import MultiTaskDataset, RankingDataset
from .encoder import (OOV_SENTINEL, FeatureSpec, encode_ranking_df,
                      fit_enc_dict)
from .loader import DataLoader
from .process_data import get_dataloader, get_single_dataloader

__all__ = [
    "OOV_SENTINEL",
    "FeatureSpec",
    "fit_enc_dict",
    "encode_ranking_df",
    "RankingDataset",
    "MultiTaskDataset",
    "DataLoader",
    "get_dataloader",
    "get_single_dataloader",
]
