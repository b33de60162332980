"""Leave-one-out sequence example on the PyTorch port, as
run_sequence_example_v2.py runs it on the JAX package (SequenceDatasetV2:
train at len-3, valid at len-2, test at len-1).

    python examples/sequence_recall/run_sequence_example_v2_torch.py [--device cpu]

SEQ_MODEL picks the model (SASRec by default) and SEQ_EPOCHS the epochs (3).
"""
import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))

import pandas as pd

from rec_pangu_tpu_torch.data import get_dataloader
from rec_pangu_tpu_torch.models import get_model
from rec_pangu_tpu_torch.train import SequenceTrainer

def parse_args():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device, e.g. cpu; the CUDA card by default")
    return parser.parse_args()


if __name__ == "__main__":
    args = parse_args()
    schema = {
        "user_col": "user_id",
        "item_col": "item_id",
        "cate_cols": ["genre"],
        "max_length": 20,
        "time_col": "timestamp",
        "task_type": "sequence",
        "protocol": "v2",
    }
    config = {"embedding_dim": 64, "lr": 0.001, "K": 4, "device": -1}
    config.update(schema)

    data_dir = os.path.join(_HERE, "sample_data")
    train_df = pd.read_csv(f"{data_dir}/sample_train.csv")
    valid_df = pd.read_csv(f"{data_dir}/sample_valid.csv")
    test_df = pd.read_csv(f"{data_dir}/sample_test.csv")

    train_loader, valid_loader, test_loader, enc_dict = get_dataloader(
        train_df, valid_df, test_df, schema, batch_size=256
    )
    model_name = os.environ.get("SEQ_MODEL", "SASRec")
    model = get_model(model_name)(enc_dict=enc_dict, config=config)
    trainer = SequenceTrainer(model_ckpt_dir="./model_ckpt_v2", device=args.device)
    trainer.fit(model, train_loader, valid_loader,
                epoch=int(os.environ.get("SEQ_EPOCHS", "3")), lr=1e-3,
                log_rounds=10)
    print("Test metric:", trainer.evaluate_model(model, test_loader))
