"""Feature encoding: schema -> enc_dict -> fused fixed-shape arrays.

Same semantics as the JAX package's encoder, which follows the reference
(rec_pangu/dataset/base_dataset.py:47-103):

* sparse column: values cast to str, sorted unique -> ids ``0..n-1``;
  ``enc_dict[col]['vocab_size'] = n``; out-of-vocabulary values map to ``n``
  (so each feature needs ``n + 1`` table rows).
* dense column: min/max recorded; encoding is ``(x - min) / (max - min + 1e-5)``.

All sparse ids of a row are packed into one ``[N, F] int32`` matrix and the
dense values into ``[N, Nd] float32``, so the model does one fused lookup.

pandas is imported inside the functions that take a DataFrame: the package
itself imports without it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

OOV_SENTINEL = "vocab_size"


def _feature_cols(schema: dict) -> tuple:
    # schema list order, deduplicated (deterministic, unlike the reference's
    # list(set(...)))
    dense = list(dict.fromkeys(schema.get("dense_cols", []) or []))
    sparse = list(dict.fromkeys(schema.get("sparse_cols", []) or []))
    return dense, sparse


def fit_enc_dict(df, schema: dict) -> Dict[str, dict]:
    """Fit a ranking/multitask enc_dict on a (train) dataframe."""
    import pandas as pd

    dense_cols, sparse_cols = _feature_cols(schema)
    enc_dict: Dict[str, dict] = {}
    for f in dense_cols:
        col = pd.to_numeric(df[f])
        enc_dict[f] = {"min": col.min(), "max": col.max()}
    for f in sparse_cols:
        uniques = sorted(df[f].astype(str).unique())
        mapping = dict(zip(uniques, range(len(uniques))))
        mapping[OOV_SENTINEL] = len(uniques)
        enc_dict[f] = mapping
    return enc_dict


def fit_sequence_enc_dict(df, schema: dict) -> Dict[str, dict]:
    """Fit a sequence enc_dict: ids 1..n, 0 = padding/OOV, vocab_size = n+1."""
    enc_dict: Dict[str, dict] = {}
    for f in [schema["item_col"]] + list(schema.get("cate_cols", []) or []):
        uniques = sorted(df[f].astype(str).unique())
        mapping = dict(zip(uniques, range(1, 1 + len(uniques))))
        mapping[OOV_SENTINEL] = len(uniques) + 1
        enc_dict[f] = mapping
    return enc_dict


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Static description of the fused feature layout, derived from enc_dict.

    ``sparse_vocab_rows[i]`` is the number of table rows feature i needs
    (vocab_size + 1, covering the OOV id); ``offsets`` are the row offsets
    of each feature's sub-table inside the fused table.
    """

    sparse_names: tuple
    dense_names: tuple
    sparse_vocab_rows: tuple

    @property
    def num_sparse(self) -> int:
        return len(self.sparse_names)

    @property
    def num_dense(self) -> int:
        return len(self.dense_names)

    @property
    def offsets(self) -> np.ndarray:
        if not self.sparse_vocab_rows:
            return np.zeros((0,), np.int32)
        return np.concatenate(
            [[0], np.cumsum(self.sparse_vocab_rows)[:-1]]).astype(np.int32)

    @property
    def total_rows(self) -> int:
        return int(sum(self.sparse_vocab_rows))

    def feature_slice(self, name: str) -> slice:
        i = self.sparse_names.index(name)
        off = int(self.offsets[i])
        return slice(off, off + int(self.sparse_vocab_rows[i]))

    @staticmethod
    def from_enc_dict(enc_dict: Dict[str, dict],
                      schema: Optional[dict] = None) -> "FeatureSpec":
        if schema is not None:
            dense_cols, sparse_cols = _feature_cols(schema)
        else:
            dense_cols = [c for c, d in enc_dict.items() if "min" in d]
            sparse_cols = [c for c, d in enc_dict.items() if OOV_SENTINEL in d]
        rows = tuple(int(enc_dict[c][OOV_SENTINEL]) + 1 for c in sparse_cols)
        return FeatureSpec(tuple(sparse_cols), tuple(dense_cols), rows)


def encode_sparse_col(values, mapping: dict) -> np.ndarray:
    oov = mapping[OOV_SENTINEL]
    out = values.astype(str).map(mapping)
    return out.fillna(oov).to_numpy(dtype=np.int32)


def encode_dense_col(values, stats: dict) -> np.ndarray:
    import pandas as pd

    lo, hi = stats["min"], stats["max"]
    return ((pd.to_numeric(values) - lo) / (hi - lo + 1e-5)).to_numpy(
        dtype=np.float32)


def encode_ranking_df(df, enc_dict: Dict[str, dict], schema: dict,
                      label_cols: Optional[List[str]] = None
                      ) -> Dict[str, np.ndarray]:
    """Encode a dataframe into fused arrays
    {'sparse': [N, F] i32, 'dense': [N, Nd] f32, 'label': [N(, T)] f32}."""
    import pandas as pd

    spec = FeatureSpec.from_enc_dict(enc_dict, schema)
    n = len(df)
    sparse = np.zeros((n, spec.num_sparse), dtype=np.int32)
    for i, col in enumerate(spec.sparse_names):
        sparse[:, i] = encode_sparse_col(df[col], enc_dict[col])
    dense = np.zeros((n, spec.num_dense), dtype=np.float32)
    for i, col in enumerate(spec.dense_names):
        dense[:, i] = encode_dense_col(df[col], enc_dict[col])
    out = {"sparse": sparse, "dense": dense}
    if label_cols and all(c in df.columns for c in label_cols):
        labels = np.stack([pd.to_numeric(df[c]).to_numpy(dtype=np.float32)
                           for c in label_cols], axis=1)
        out["label"] = labels[:, 0] if len(label_cols) == 1 else labels
    return out
