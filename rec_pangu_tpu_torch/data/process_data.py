"""Schema-driven dataloader dispatch.

``schema['task_type']`` routes to the matching dataset triple; the enc_dict
is fit on the train split only and shared with valid/test.
"""
from __future__ import annotations

from typing import Tuple

from .dataset import MultiTaskDataset, RankingDataset
from .loader import DataLoader
from .sequence import SequenceDataset, SequenceDatasetV2

DEFAULT_BATCH_SIZE = 512 * 3


def _split_loaders(cls, train_df, valid_df, test_df, schema, batch_size):
    train_ds = cls(schema, train_df)
    valid_ds = cls(schema, valid_df, enc_dict=train_ds.enc_dict)
    test_ds = cls(schema, test_df, enc_dict=train_ds.enc_dict)
    return (
        DataLoader(train_ds, batch_size, shuffle=True),
        DataLoader(valid_ds, batch_size, shuffle=False),
        DataLoader(test_ds, batch_size, shuffle=False),
        train_ds.enc_dict,
    )


def _sequence_dataloader(cls, train_df, valid_df, test_df, schema, batch_size):
    train_ds = cls(schema, train_df, phase="train")
    valid_ds = cls(schema, valid_df, enc_dict=train_ds.enc_dict, phase="valid")
    test_ds = cls(schema, test_df, enc_dict=train_ds.enc_dict, phase="test")
    return (
        DataLoader(train_ds, batch_size, shuffle=True),
        DataLoader(valid_ds, batch_size, shuffle=False),
        DataLoader(test_ds, batch_size, shuffle=False),
        train_ds.enc_dict,
    )


def get_sequence_dataloader(train_df, valid_df, test_df, schema,
                            batch_size: int = DEFAULT_BATCH_SIZE) -> Tuple:
    return _sequence_dataloader(SequenceDataset, train_df, valid_df, test_df, schema,
                                batch_size)


def get_sequence_dataloader_v2(train_df, valid_df, test_df, schema,
                               batch_size: int = DEFAULT_BATCH_SIZE) -> Tuple:
    return _sequence_dataloader(SequenceDatasetV2, train_df, valid_df, test_df, schema,
                                batch_size)


def get_single_dataloader(test_df, schema: dict, enc_dict: dict,
                          batch_size: int = 512) -> DataLoader:
    """One never-shuffled loader over a raw df encoded with a saved enc_dict:
    a MultiTaskDataset when ``label_col`` is a list, a RankingDataset
    otherwise."""
    if isinstance(schema.get("label_col"), list):
        ds = MultiTaskDataset(schema, test_df, enc_dict=enc_dict)
    else:
        ds = RankingDataset(schema, test_df, enc_dict=enc_dict)
    return DataLoader(ds, batch_size, shuffle=False)


def get_dataloader(train_df, valid_df, test_df, schema: dict,
                   batch_size: int = DEFAULT_BATCH_SIZE) -> Tuple:
    task_type = schema["task_type"]
    if task_type == "ranking":
        return _split_loaders(RankingDataset, train_df, valid_df, test_df,
                              schema, batch_size)
    if task_type == "multitask":
        return _split_loaders(MultiTaskDataset, train_df, valid_df, test_df,
                              schema, batch_size)
    if task_type == "sequence":
        if schema.get("protocol", "v1") == "v2":
            return get_sequence_dataloader_v2(train_df, valid_df, test_df, schema, batch_size)
        return get_sequence_dataloader(train_df, valid_df, test_df, schema, batch_size)
    raise ValueError(f"Unknown task_type: {task_type!r}")
