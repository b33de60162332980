from .dataset import MultiTaskDataset, RankingDataset
from .graph_dataset import GeneralGraphDataset
from .encoder import (OOV_SENTINEL, FeatureSpec, encode_ranking_df,
                      fit_enc_dict, fit_sequence_enc_dict)
from .loader import DataLoader
from .process_data import (get_dataloader, get_sequence_dataloader,
                           get_sequence_dataloader_v2, get_single_dataloader)
from .sequence import SequenceDataset, SequenceDatasetV2, seq_collate

__all__ = [
    "OOV_SENTINEL",
    "FeatureSpec",
    "GeneralGraphDataset",
    "fit_enc_dict",
    "fit_sequence_enc_dict",
    "encode_ranking_df",
    "RankingDataset",
    "MultiTaskDataset",
    "DataLoader",
    "get_dataloader",
    "get_single_dataloader",
    "get_sequence_dataloader",
    "get_sequence_dataloader_v2",
    "SequenceDataset",
    "SequenceDatasetV2",
    "seq_collate",
]
