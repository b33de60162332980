"""Multi-task benchmark sweep on the PyTorch port, as
run_multi_task_benchmark_example.py runs it on the JAX package: the six
multi-task models on the bundled sample data, one CSV row a model.

    python examples/multi_task/run_multi_task_benchmark_example_torch.py [--device cpu]
"""
import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))

import pandas as pd

from rec_pangu_tpu_torch.data import get_dataloader
from rec_pangu_tpu_torch.train import BenchmarkTrainer

def parse_args():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device, e.g. cpu; the CUDA card by default")
    return parser.parse_args()


if __name__ == "__main__":
    args = parse_args()
    df = pd.read_csv(os.path.join(_HERE, "sample_data", "multi_task_sample_data.csv"))
    schema = {
        "sparse_cols": ["user_id", "item_id", "item_type", "dayofweek", "is_workday",
                        "city", "county", "town", "village", "lbs_city", "lbs_district",
                        "hardware_platform", "hardware_ischarging", "os_type",
                        "network_type", "position"],
        "dense_cols": ["item_expo_1d", "item_expo_7d", "item_expo_14d", "item_expo_30d",
                       "item_clk_1d", "item_clk_7d", "item_clk_14d", "item_clk_30d",
                       "use_duration"],
        "label_col": ["click", "scroll"],
        "task_type": "multitask",
    }
    train_loader, valid_loader, test_loader, enc_dict = get_dataloader(
        df, df, df, schema, batch_size=512
    )
    model_list = ["MMOE", "AITM", "ShareBottom", "ESSM", "OMOE", "MLMMOE"]
    benchmark = BenchmarkTrainer(
        model_list=model_list,
        num_task=2,
        model_ckpt_dir="./multi_task_benchmark_ckpt",
        benchmark_res_path="./multi_task_benchmark_res.csv",
    )
    # every multi-task model defaults to num_task=2 (ESSM/AITM are fixed 2-task)
    results = benchmark.run(
        train_loader, valid_loader, test_loader, enc_dict, epoch=3, lr=1e-3,
        device=args.device,
    )
    print(results)
