"""Extension point on the PyTorch port, as custom_model.py shows it on the
JAX package: subclass SequenceModelBase and get the item embeddings, the
full-softmax loss and the registry for free.

    python examples/sequence_recall/custom_model_torch.py [--device cpu]
"""
import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))

import torch

from rec_pangu_tpu_torch.convert import prefixed
from rec_pangu_tpu_torch.models import SequenceModelBase, register_model
from rec_pangu_tpu_torch.ops.mlp import MLP


@register_model("CustomModel")
class CustomModel(SequenceModelBase):
    """Masked-mean pooling + a small MLP head."""

    def __init__(self, enc_dict: dict, config: dict, seed: int = 1029):
        super().__init__(enc_dict, config, seed)
        self.setup_base()
        self.head = MLP(self.embedding_dim, (self.embedding_dim,),
                        output_dim=self.embedding_dim, dropout_rates=0.0,
                        generator=self.generator)

    def forward(self, batch, train: bool = False, capture=None, seed=None):
        seq_emb = self.item_emb(batch["hist_item_list"])
        mask = batch["hist_mask_list"][..., None]
        pooled = (seq_emb * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)
        user_emb = self.head(pooled, train)
        out = {"user_emb": user_emb}
        if train:
            out["loss"] = self.calculate_loss(user_emb, batch["target_item"], seed=seed)
        return out

    def jax_leaves(self):
        return (prefixed("item_emb", self.item_emb.jax_leaves())
                + prefixed("head", self.head.jax_leaves()))


def parse_args():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device, e.g. cpu; the CUDA card by default")
    return parser.parse_args()


if __name__ == "__main__":
    import pandas as pd

    from rec_pangu_tpu_torch.data import get_dataloader
    from rec_pangu_tpu_torch.train import SequenceTrainer

    args = parse_args()
    schema = {"user_col": "user_id", "item_col": "item_id", "cate_cols": ["genre"],
              "max_length": 20, "time_col": "timestamp", "task_type": "sequence"}
    config = {"embedding_dim": 64, "K": 4, "device": -1, **schema}
    data_dir = os.path.join(_HERE, "sample_data")
    loaders = get_dataloader(pd.read_csv(f"{data_dir}/sample_train.csv"),
                             pd.read_csv(f"{data_dir}/sample_valid.csv"),
                             pd.read_csv(f"{data_dir}/sample_test.csv"),
                             schema, batch_size=256)
    train_loader, valid_loader, test_loader, enc_dict = loaders
    model = CustomModel(enc_dict=enc_dict, config=config)
    trainer = SequenceTrainer(model_ckpt_dir="./model_ckpt_custom", device=args.device)
    trainer.fit(model, train_loader, valid_loader, epoch=2, lr=1e-3, log_rounds=10)
    print("Test metric:", trainer.evaluate_model(model, test_loader))
