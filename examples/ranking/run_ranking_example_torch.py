"""Ranking example on the PyTorch port: DeepFM on the bundled sample data,
as run_ranking_example.py runs it on the JAX package.

    python examples/ranking/run_ranking_example_torch.py [--device cpu]

Writes ./model_ckpt/model.ckpt (weights, optimizer state, enc_dict), which
inference_example_torch.py reads.
"""
import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))

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
    train_df, valid_df, test_df = df[:80], df[:90], df[:95]

    train_loader, valid_loader, test_loader, enc_dict = get_dataloader(
        train_df, valid_df, test_df, schema, batch_size=512
    )
    model = get_model("DeepFM")(enc_dict=enc_dict)
    trainer = RankTrainer(num_task=1, model_ckpt_dir="./model_ckpt", device=args.device)
    trainer.fit(model, train_loader, valid_loader, epoch=50, lr=1e-3,
                use_earlystopping=True, max_patience=5,
                monitor_metric="roc_auc_score")
    trainer.save_all(model, enc_dict, "./model_ckpt")
    test_metric = trainer.evaluate_model(model, test_loader)
    print("Test metric:", test_metric)

    preds = trainer.predict_dataframe(model, test_df, enc_dict, schema)
    print("predict_dataframe:", preds[:5], "...", preds.shape)
