"""The ranking and multi-task zoos' quality legs for the PyTorch port, by
the protocols of ``scripts/fill_baseline.py``, run by
``rec_pangu_tpu_torch`` on the CPU (the kernels' plain versions):

* ``ratings3/<model>``: MovieLens ratings.csv as CTR (click = rating >= 4,
  the fixed shuffled 80/10/10 split of ``parity_common.load_ratings_ctr``),
  5 epochs, batch 512, Adam 1e-3, test AUC of the final model over seeds
  1029-1031;
* ``mtl3/<model>`` (MMOE, ESSM, AITM): ratings.csv as two nested tasks
  (``load_ratings_mtl``: like = rating >= 3, click = rating >= 4), the same
  split, budget and seeds, validation each epoch, test AUC of each task;
* ``ratings_mtl/<model>`` (ShareBottom, OMOE, MLMMOE): the same at seed
  1029 alone;
* ``graph/NGCF``: ratings.csv as a bipartite graph (``load_graph_cf``: a
  fixed shuffled 80/20 row split), NGCF with embedding 64 and two layers
  of 64, ``GraphTrainer.fit`` for 5 epochs of BPR batches of 512, Adam
  1e-3, recall, ndcg and hit rate at 50 over the test users, seed 1029 (the
  dataset's sampler, the weights and the dropout seeds), beside the JAX
  package's single run.

Each seed seeds the model's weights (its constructor), the train loader's
shuffle and ``fit``'s dropout seeds.

Writes ``baseline_results_torch.json`` at the repo root, one key per leg
with the seeds' metrics, the AUC mean, min and max (each task's for the
multi-task legs), and the JAX package's range for the same leg (read from
``baseline_results.json``) with whether the two overlap (a one-seed leg:
the port's AUC minus the JAX package's).  Keys already in
the file are skipped, so an interrupted run resumes.

    python scripts/fill_baseline_torch.py [--models WDL,AFN] [--mtl MMOE,OMOE] [--graph NGCF]
                                          [--threads 4]

Imports nothing of the JAX package and no JAX.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from parity_common import (GRAPH_BATCH, GRAPH_EPOCHS, GRAPH_TOPN,  # noqa: E402
                           MTL_RATINGS_MODELS, MTL_RATINGS_MODELS_EXTRA, RANKING_MODELS,
                           RANKING_MODELS_EXTRA, RATINGS_BATCH, RATINGS_EPOCHS,
                           RATINGS_MTL_SCHEMA, RATINGS_SCHEMA, load_graph_cf,
                           load_ratings_ctr, load_ratings_mtl, repo_path)

from rec_pangu_tpu_torch.data import (DataLoader, GeneralGraphDataset,  # noqa: E402
                                      get_dataloader)
from rec_pangu_tpu_torch.models import get_model  # noqa: E402
from rec_pangu_tpu_torch.train import GraphTrainer, RankTrainer  # noqa: E402

OUT = repo_path("baseline_results_torch.json")
JAX_RESULTS = repo_path("baseline_results.json")
SEEDS3 = [1029, 1030, 1031]


def jax_range(key: str):
    """(min, mean, max) of the JAX package's leg ``key``, or None."""
    with open(JAX_RESULTS) as f:
        leg = json.load(f).get(key)
    return None if leg is None else (leg["auc_min"], leg["auc_mean"], leg["auc_max"])


def auc_range(aucs):
    return {"auc_mean": round(sum(aucs) / len(aucs), 4), "auc_min": min(aucs),
            "auc_max": max(aucs)}


def jax_mtl_ranges(key: str):
    """{task: (min, mean, max)} of the JAX package's multi-task leg ``key``
    (its seeds' test AUCs, or its one run's), or None."""
    with open(JAX_RESULTS) as f:
        leg = json.load(f).get(key)
    if leg is None:
        return None
    runs = list(leg["seeds"].values()) if "seeds" in leg else [leg["test"]]
    out = {}
    for t in (1, 2):
        aucs = [r[f"test_task{t}_roc_auc_score"] for r in runs]
        out[f"task{t}"] = (min(aucs), round(sum(aucs) / len(aucs), 4), max(aucs))
    return out


def run_mtl(name: str, seeds, loaders, threads: int) -> dict:
    """One multi-task leg: ``fit`` RATINGS_EPOCHS with validation, then the
    test metrics, for each seed."""
    train_loader, valid_loader, test_loader, enc_dict = loaders
    runs, t0 = [], time.time()
    for seed in seeds:
        loader = DataLoader(train_loader.dataset, batch_size=RATINGS_BATCH, shuffle=True,
                            seed=seed)
        model = get_model(name)(enc_dict=enc_dict, seed=seed)
        with tempfile.TemporaryDirectory() as ckpt_dir:
            trainer = RankTrainer(num_task=2, model_ckpt_dir=ckpt_dir, device="cpu")
            trainer.fit(model, loader, valid_loader, epoch=RATINGS_EPOCHS, lr=1e-3, seed=seed,
                        log_rounds=10 ** 9)
            runs.append(trainer.evaluate_model(model, test_loader))
    leg = {"seeds": dict(zip(map(str, seeds), runs))}
    for t in (1, 2):
        leg[f"task{t}"] = auc_range([r[f"test_task{t}_roc_auc_score"] for r in runs])
    leg.update({"train_s": round(time.time() - t0, 1), "device": "cpu", "threads": threads})
    return leg


def run_graph_cf(threads: int, seed: int = 1029) -> dict:
    """The graph/NGCF leg (see the module's docstring), beside the JAX
    package's one run."""
    train_df, test_df, n_user, n_item = load_graph_cf()
    t0 = time.time()
    train_ds = GeneralGraphDataset(train_df, n_user, n_item, phase="train", seed=seed)
    test_ds = GeneralGraphDataset(test_df, n_user, n_item, phase="test", seed=seed)
    model = get_model("NGCF")(num_user=n_user, num_item=n_item, embedding_dim=64,
                              hidden_size=(64, 64), g=train_ds.generate_graph("cpu"), seed=seed)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = GraphTrainer(model_ckpt_dir=ckpt_dir, device="cpu")
        trainer.fit(model, train_ds, epoch=GRAPH_EPOCHS, lr=1e-3, batch_size=GRAPH_BATCH,
                    seed=seed)
        metric = trainer.evaluate_model(model, train_ds, test_ds, topN=GRAPH_TOPN)
    leg = {"seeds": {str(seed): metric}, "train_s": round(time.time() - t0, 1),
           "device": "cpu", "threads": threads}
    with open(JAX_RESULTS) as f:
        jax_leg = json.load(f).get("graph/NGCF")
    if jax_leg is not None:
        leg["jax_test"] = jax_leg["test"]
        leg["minus_jax"] = {k: round(v - jax_leg["test"][k], 4) for k, v in metric.items()}
    return leg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default=",".join(RANKING_MODELS + RANKING_MODELS_EXTRA))
    ap.add_argument("--mtl", default=",".join(MTL_RATINGS_MODELS + MTL_RATINGS_MODELS_EXTRA),
                    help="multi-task models: mtl3/ legs for MMOE, ESSM, AITM, "
                         "ratings_mtl/ (seed 1029) for the others")
    ap.add_argument("--graph", default="NGCF", help="graph/NGCF's leg ('' skips it)")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    results = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)

    train_df, valid_df, test_df = load_ratings_ctr()
    train_loader, valid_loader, test_loader, enc_dict = get_dataloader(
        train_df, valid_df, test_df, RATINGS_SCHEMA, batch_size=RATINGS_BATCH)
    for name in [m for m in args.models.split(",") if m]:
        key = f"ratings3/{name}"
        if key in results:
            continue
        runs, t0 = [], time.time()
        for seed in SEEDS3:
            loader = DataLoader(train_loader.dataset, batch_size=RATINGS_BATCH, shuffle=True,
                                seed=seed)
            model = get_model(name)(enc_dict=enc_dict, seed=seed)
            with tempfile.TemporaryDirectory() as ckpt_dir:
                trainer = RankTrainer(num_task=1, model_ckpt_dir=ckpt_dir, device="cpu")
                trainer.fit(model, loader, valid_loader, epoch=RATINGS_EPOCHS, lr=1e-3,
                            seed=seed, log_rounds=10 ** 9)
                runs.append(trainer.evaluate_model(model, test_loader))
        aucs = [r["roc_auc_score"] for r in runs]
        leg = {"seeds": dict(zip(map(str, SEEDS3), runs)),
               "auc_mean": round(sum(aucs) / len(aucs), 4), "auc_min": min(aucs),
               "auc_max": max(aucs), "train_s": round(time.time() - t0, 1),
               "device": "cpu", "threads": args.threads}
        jax_leg = jax_range(key)
        if jax_leg is not None:
            leg["jax_auc_min_mean_max"] = list(jax_leg)
            leg["overlaps_jax"] = leg["auc_min"] <= jax_leg[2] and jax_leg[0] <= leg["auc_max"]
        results[key] = leg
        with open(OUT, "w") as f:
            json.dump(results, f, indent=2)
        print(key, json.dumps(leg), flush=True)

    mtl = [m for m in args.mtl.split(",") if m]
    loaders = get_dataloader(*load_ratings_mtl(), RATINGS_MTL_SCHEMA,
                             batch_size=RATINGS_BATCH) if mtl else None
    for name in mtl:
        three = name in MTL_RATINGS_MODELS
        key = f"{'mtl3' if three else 'ratings_mtl'}/{name}"
        if key in results:
            continue
        leg = run_mtl(name, SEEDS3 if three else SEEDS3[:1], loaders, args.threads)
        jax_legs = jax_mtl_ranges(key)
        if jax_legs is not None:
            for task, (lo, mean, hi) in jax_legs.items():
                leg[task]["jax_auc_min_mean_max"] = [lo, mean, hi]
                if three:  # two ranges of three seeds
                    leg[task]["overlaps_jax"] = (leg[task]["auc_min"] <= hi
                                                 and lo <= leg[task]["auc_max"])
                else:  # one draw on each side: their difference
                    leg[task]["minus_jax"] = round(leg[task]["auc_mean"] - mean, 4)
        results[key] = leg
        with open(OUT, "w") as f:
            json.dump(results, f, indent=2)
        print(key, json.dumps(leg), flush=True)

    if args.graph and "graph/NGCF" not in results:
        results["graph/NGCF"] = run_graph_cf(args.threads)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=2)
        print("graph/NGCF", json.dumps(results["graph/NGCF"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
