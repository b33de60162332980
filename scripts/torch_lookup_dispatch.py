"""What the lookup's route costs the host: the registered op
(``rec_pangu_tpu_torch::embedding_lookup``) against another tree's route,
such as a parent commit's ``torch.autograd.Function``.

Each tree is measured in a process of its own that imports that tree's
package (its kernels built from its own sources), in turns: the other tree,
this one, this one, the other, for ``--rounds`` rounds.  A process measures,
at the bench's width (DeepFM, 16 fields of 100,000 ids, D = 32, MLP (64, 64,
64), 8,192-row requests; random weights from the port's init and a seed):

* ``lookup_host_us``: the host's time per lookup call on a [64, 16] batch
  (the card keeps up: the calls' host time is all there is), under
  ``torch.inference_mode`` as the scorer calls it; ``lookup_capture_host_us``
  with grad enabled on the detached table, as the fused step's capture
  calls it; and ``lookup_grad_host_us`` with the table requiring grad
  (autograd records the backward, as the standard step does);
* ``serving_p50_ms``/``p90``: requests through ``make_ranking_scorer``
  (host id check, upload, forward, copy back);
* ``step_p50_ms``/``p90``: the fused train step (K1 + K3), from the host
  batch's upload to the step's end (synchronized).

    python3 scripts/torch_lookup_dispatch.py --other _archive/parent [--rounds 2]
                                     # on a machine with a CUDA card

Prints one JSON line a process, then one with each tree's medians and the
card's name and power limit; the lines are also written to
``chiprun_out/lookup_dispatch.json``.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS, VOCAB, DENSE, DIM, HIDDEN, BATCH = 16, 100_000, 9, 32, (64, 64, 64), 8192
SMALL_BATCH = 64
LOOKUP_CALLS = 2000
WARMUP, REQUESTS, STEPS = 5, 100, 60
LR = 1e-3


def measure(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import rec_pangu_tpu_torch as port
    from rec_pangu_tpu_torch.ops.kernels import embedding_lookup as lookup
    from rec_pangu_tpu_torch.serving import make_ranking_scorer
    from rec_pangu_tpu_torch.train.fused_update import maybe_enable_fused_update

    if not os.path.abspath(port.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {port.__file__}, not the package of {tree}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    enc_dict = {**{f"C{f + 1}": {"vocab_size": VOCAB} for f in range(FIELDS)},
                **{f"I{d + 1}": {"min": 0.0, "max": 1.0} for d in range(DENSE)}}
    model = port.get_model("DeepFM")(enc_dict=enc_dict, embedding_dim=DIM,
                                     hidden_units=HIDDEN, seed=7).to(dev)
    rng = np.random.default_rng(11)

    def request(rows):
        return {"sparse": rng.integers(0, VOCAB + 1, (rows, FIELDS)).astype(np.int32),
                "dense": rng.random((rows, DENSE)).astype(np.float32),
                "label": (rng.random(rows) < 0.5).astype(np.float32)}

    emb = model.embedding
    small = torch.from_numpy(request(SMALL_BATCH)["sparse"]).to(dev)

    def host_us(mode: str) -> float:
        table = emb.table.detach() if mode == "capture" else emb.table
        ctx = torch.inference_mode() if mode == "inference" else torch.enable_grad()
        with ctx:
            for _ in range(50):
                lookup.fused_embedding_lookup(table, small, emb.offsets)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LOOKUP_CALLS):
                lookup.fused_embedding_lookup(table, small, emb.offsets)
            spent = time.perf_counter() - t0
            torch.cuda.synchronize()
        return spent / LOOKUP_CALLS * 1e6

    lookup_us, capture_us, grad_us = (host_us(m) for m in ("inference", "capture", "grad"))

    score = make_ranking_scorer(model, device=dev)
    reqs = [request(BATCH) for _ in range(WARMUP + REQUESTS)]
    latencies = []
    for i, req in enumerate(reqs):
        t0 = time.perf_counter()
        score(req)
        if i >= WARMUP:
            latencies.append(time.perf_counter() - t0)

    model.train()
    step = maybe_enable_fused_update(model, LR, WARMUP + STEPS)
    if step is None:
        raise RuntimeError("the fused step did not engage")
    step_times = []
    for i in range(WARMUP + STEPS):
        req = reqs[i % len(reqs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model.upload_batch(req, dev, train=True), i)
        torch.cuda.synchronize()
        if i >= WARMUP:
            step_times.append(time.perf_counter() - t0)
    route = "registered op" if hasattr(lookup, "embedding_lookup_op") else "autograd.Function"
    return {"tree": tree, "lookup_route": route,
            "lookup_host_us": lookup_us, "lookup_capture_host_us": capture_us,
            "lookup_grad_host_us": grad_us,
            "serving_p50_ms": statistics.median(latencies) * 1e3,
            "serving_p90_ms": float(np.percentile(latencies, 90)) * 1e3,
            "step_p50_ms": statistics.median(step_times) * 1e3,
            "step_p90_ms": float(np.percentile(step_times, 90)) * 1e3}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--other", help="the root of the tree to compare with")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--measure", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_lookup_dispatch: CUDA is not available", file=sys.stderr)
        return 1
    other = os.path.abspath(args.other)
    order = []
    for _ in range(args.rounds):
        order += [other, ROOT, ROOT, other]
    lines = []
    for tree in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", tree],
                             cwd=tree, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        lines.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(lines[-1]), flush=True)
    keys = [k for k in lines[0] if k.endswith(("_us", "_ms"))]
    summary = {}
    for tree in (ROOT, other):
        runs = [line for line in lines if line["tree"] == tree]
        summary["this" if tree == ROOT else "other"] = {
            "route": runs[0]["lookup_route"],
            **{k: statistics.median(r[k] for r in runs) for k in keys}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    summary["nvidia_smi"] = smi
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "lookup_dispatch.json"), "w") as f:
        for line in lines + [summary]:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
