"""Ranking / multi-task datasets over fused numpy arrays.

Each holds its whole encoded split as fused arrays (``self.arrays``);
batching is array slicing in :class:`~.loader.DataLoader`.
"""
from __future__ import annotations

from typing import List, Optional

from .encoder import FeatureSpec, encode_ranking_df, fit_enc_dict


class RankingDataset:
    def __init__(self, schema: dict, df, enc_dict: Optional[dict] = None):
        self.schema = schema
        self.enc_dict = enc_dict if enc_dict is not None else fit_enc_dict(df, schema)
        self.spec = FeatureSpec.from_enc_dict(self.enc_dict, schema)
        label_col = schema.get("label_col")
        self.label_cols: List[str] = [label_col] if label_col else []
        self.arrays = encode_ranking_df(df, self.enc_dict, schema, self.label_cols)

    def __len__(self) -> int:
        return len(self.arrays["sparse"])


class MultiTaskDataset(RankingDataset):
    def __init__(self, schema: dict, df, enc_dict: Optional[dict] = None):
        label_cols = list(schema.get("label_col", []) or [])
        self.num_task = len(label_cols)
        self.schema = schema
        self.enc_dict = enc_dict if enc_dict is not None else fit_enc_dict(df, schema)
        self.spec = FeatureSpec.from_enc_dict(self.enc_dict, schema)
        self.label_cols = label_cols
        self.arrays = encode_ranking_df(df, self.enc_dict, schema, label_cols)
        # the multi-task label is [N, T], even for T == 1
        if "label" in self.arrays and self.arrays["label"].ndim == 1:
            self.arrays["label"] = self.arrays["label"][:, None]
