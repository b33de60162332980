"""Pretrained embeddings on the PyTorch port, as
run_set_pretrained_emb_example.py runs it on the JAX package: WDL with
frozen pretrained rows for 50 users.

    python examples/ranking/run_set_pretrained_emb_example_torch.py [--device cpu]
"""
import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))

import numpy as np
import pandas as pd

from rec_pangu_tpu_torch.data import get_dataloader
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.train import RankTrainer

def parse_args():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device, e.g. cpu; the CUDA card by default")
    return parser.parse_args()


if __name__ == "__main__":
    args = parse_args()
    df = pd.read_csv(os.path.join(_HERE, "sample_data", "ranking_sample_data.csv"))
    schema = {
        "sparse_cols": ["user_id", "item_id", "item_type", "dayofweek", "is_workday",
                        "city", "county", "town", "village", "lbs_city", "lbs_district",
                        "hardware_platform", "hardware_ischarging", "os_type",
                        "network_type", "position"],
        "dense_cols": ["item_expo_1d", "item_expo_7d", "item_expo_14d", "item_expo_30d",
                       "item_clk_1d", "item_clk_7d", "item_clk_14d", "item_clk_30d",
                       "use_duration"],
        "label_col": "click",
        "task_type": "ranking",
    }
    train_loader, valid_loader, test_loader, enc_dict = get_dataloader(
        df[:80], df[:90], df[:95], schema, batch_size=512
    )
    dim = 32
    # pretend these came from a pretrained user tower
    pretrained_user_emb = {
        u: np.random.default_rng(0).random(dim).astype(np.float32)
        for u in list(enc_dict["user_id"])[:50] if u != "vocab_size"
    }
    model = get_model("WDL")(enc_dict=enc_dict, embedding_dim=dim)
    trainer = RankTrainer(num_task=1, model_ckpt_dir="./model_ckpt", device=args.device)
    trainer.set_pretrained_weights(model, "user_id", pretrained_user_emb,
                                   trainable=False)
    trainer.fit(model, train_loader, valid_loader, epoch=10, lr=1e-3)
    print("Test metric:", trainer.evaluate_model(model, test_loader))
