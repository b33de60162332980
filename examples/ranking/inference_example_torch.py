"""Inference round trip on the PyTorch port, as inference_example.py runs it
on the JAX package: load a saved checkpoint (weights + enc_dict), rebuild
the model, predict on a label-less dataframe; then export the model with
export_program, load the program back and predict through it.

    python examples/ranking/inference_example_torch.py [--device cpu]

Reads ./model_ckpt/model.ckpt, as run_ranking_example_torch.py writes it,
and writes the program to ./model_ckpt/deepfm.pt2.
"""
import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))

import numpy as np
import pandas as pd
import torch

from rec_pangu_tpu_torch.data import get_single_dataloader
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.serving import export_program
from rec_pangu_tpu_torch.train import RankTrainer, load_checkpoint

def parse_args():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device, e.g. cpu; the CUDA card by default")
    return parser.parse_args()


if __name__ == "__main__":
    args = parse_args()
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
    ckpt = load_checkpoint("./model_ckpt/model.ckpt")
    enc_dict = ckpt["enc_dict"]

    df = pd.read_csv(
        os.path.join(_HERE, "sample_data", "ranking_sample_data.csv")
    ).drop(columns=["click", "scroll"])[:20]

    model = get_model("DeepFM")(enc_dict=enc_dict)
    trainer = RankTrainer(num_task=1, device=args.device)
    trainer.load_model(model, "./model_ckpt/model.ckpt")
    preds = trainer.predict_dataframe(model, df, enc_dict, schema)
    print("Predictions:", preds[:10])

    # the same model as a saved torch.export program, its batch size dynamic
    path = export_program(model, enc_dict, "./model_ckpt/deepfm.pt2", device=args.device)
    program = torch.export.load(path).module()
    device = trainer.device
    exported = []
    for batch in get_single_dataloader(df, schema, enc_dict, batch_size=8):
        with torch.no_grad():
            out = program(torch.from_numpy(batch["sparse"]).to(device),
                          torch.from_numpy(batch["dense"]).to(device))
        exported.append(out.cpu().numpy())
    exported = np.concatenate(exported)
    print("Exported program predictions:", exported[:10])
    print("max abs difference:", float(np.abs(exported - preds).max()))
