"""Where a fit of K steps a call spends its time against one step a call,
for a device-bound and a host-bound model:

* IOCRec at bench.py's shape (``chip_smoke.IOC_CONFIG``, 1,000,000 items,
  1,024 histories of 50), ``SequenceTrainer.fit`` over 8 batches;
* DeepFM at the bench's width (``chip_smoke.write_checkpoint``: 16 fields
  of 100,000 ids, D = 32, batch 8,192), ``RankTrainer.fit`` over 32
  batches.

Random weights from a seed.  The trainer runs one step a call for every
``steps_per_call``; K = 4 here is the variant it does not take
(``stacked_steps``): K host batches checked on the CPU, stacked into one
pinned buffer, copied to the card at once and stepped back to back.  The
two run in turns (1, 4, 4, 1), each fit once alone (wall time) and once
under ``torch.profiler`` (the card's busy time and idle share), with the
host's time in the batches' host keys (views) and the stacked uploads.

    python3 scripts/torch_k_steps.py [--model IOCRec|DeepFM|both] [--rounds 3]
                                     # on a machine with a CUDA card

Prints one JSON line a fit, then one with the medians of each K.
"""
import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from rec_pangu_tpu_torch.models import get_model  # noqa: E402
from rec_pangu_tpu_torch.train import RankTrainer, SequenceTrainer  # noqa: E402
from rec_pangu_tpu_torch.train.steps import strip_host_keys  # noqa: E402

K = 4
STEPS = {"IOCRec": 8, "DeepFM": 32}


def timed(fn, spent: list):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        spent.append(time.perf_counter() - t0)
        return out
    return wrapper


def upload_stacked(inputs, device: torch.device) -> dict:
    """K host batches of one layout as {key: [K, ...]} on ``device``: stacked
    into one pinned host buffer (each key at a 16-byte boundary), copied
    in one non-blocking host-to-device copy, and viewed back per key."""
    k_batches = len(inputs)
    layout, size = [], 0
    for key, t in inputs[0].items():
        nbytes = k_batches * t.numel() * t.element_size()
        layout.append((key, size, nbytes, t.dtype, (k_batches,) + tuple(t.shape)))
        size += -(-nbytes // 16) * 16
    buf = torch.empty(size, dtype=torch.uint8, pin_memory=device.type == "cuda")
    for key, off, nbytes, dtype, shape in layout:
        torch.stack([x[key] for x in inputs], out=buf[off:off + nbytes].view(dtype).view(shape))
    buf = buf.to(device, non_blocking=True)
    return {key: buf[off:off + nbytes].view(dtype).view(shape)
            for key, off, nbytes, dtype, shape in layout}


def stacked_steps(trainer, k: int, spent: list):
    """A replacement for ``trainer._steps``: K batches a call through
    ``upload_stacked`` (its host time appended to ``spent``), their steps
    launched back to back before any is handed on; the tail one at a
    time.  The batches of both models here are of one layout."""
    cpu = torch.device("cpu")

    def run(inputs):
        out = trainer._train_step(inputs, trainer.step)
        trainer.step += 1
        return out

    def steps(train_loader):
        group = []
        for batch in train_loader:
            batch, _ = strip_host_keys(batch)
            group.append((batch, trainer.model.upload_batch(trainer._host_inputs(batch), cpu,
                                                            train=True)))
            if len(group) == k:
                t0 = time.perf_counter()
                stacked = upload_stacked([host for _, host in group], trainer._fit_device)
                spent.append(time.perf_counter() - t0)
                outs = [run({key: v[i] for key, v in stacked.items()}) for i in range(k)]
                yield from zip([b for b, _ in group], outs)
                group = []
        for batch, host in group:
            yield batch, run({key: v.to(trainer._fit_device) for key, v in host.items()})

    return steps


def iocrec_setup(tmp: str):
    """A maker of (model, trainer, loader) for IOCRec, each fit from the same
    weights and batches."""
    enc = {"item_id": {"vocab_size": cs.SEQ_VOCAB}}
    weights = get_model("IOCRec")(enc_dict=enc, config=cs.IOC_CONFIG).state_dict()

    def make():
        model = get_model("IOCRec")(enc_dict=enc, config=cs.IOC_CONFIG).cuda()
        model.load_state_dict(weights)
        return (model, SequenceTrainer(device="cuda", model_ckpt_dir=tmp),
                cs.seq_train_loader(STEPS["IOCRec"], cs.SEED + 95))

    return make


def deepfm_setup(tmp: str):
    """The same for DeepFM, its labels drawn at a click rate of 0.3."""
    path = os.path.join(tmp, "deepfm.ckpt")
    enc = cs.write_checkpoint(path)

    def make():
        return (cs.load_model(path, enc, "cuda"), RankTrainer(device="cuda", model_ckpt_dir=tmp),
                cs.labelled_loader(lambda r: np.full(len(r["sparse"]), 0.3),
                                   STEPS["DeepFM"], cs.SEED + 4))

    return make


def one_fit(name: str, make, k: int, profiled: bool) -> dict:
    from torch.profiler import ProfilerActivity, profile

    model, trainer, loader = make()
    host, upload = [], []
    trainer._host_inputs = timed(trainer._host_inputs, host)
    if k > 1:
        trainer._steps = stacked_steps(trainer, k, upload)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        if profiled:
            prof.start()
        t0 = time.perf_counter()
        trainer.fit(model, loader, None, epoch=1, lr=cs.LR, log_rounds=10 ** 9,
                    seed=cs.SEED, steps_per_call=k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if profiled:
            prof.stop()
    out = {"model": name, "k": k, "profiled": profiled, "wall_s": wall, "host_keys_s": sum(host),
           "stacked_upload_s": sum(upload)}
    if profiled:
        busy, ops = cs.profile_ops(prof, STEPS[name], "step")
        out.update({"device_busy_s": busy, "idle_share": 1 - busy / wall, "top_ops": ops[:5]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("IOCRec", "DeepFM", "both"), default="both")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k_steps: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs._build.build_all()
    names = ("IOCRec", "DeepFM") if args.model == "both" else (args.model,)
    setups = {"IOCRec": iocrec_setup, "DeepFM": deepfm_setup}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            make = setups[name](tmp)
            one_fit(name, make, 1, False)  # warm: builds, first calls
            for _ in range(args.rounds):
                for k in (1, K, K, 1):
                    for profiled in (False, True):
                        runs.append(one_fit(name, make, k, profiled))
                        print(json.dumps(runs[-1]), flush=True)
            torch.cuda.empty_cache()

    def median(name, k, profiled, key):
        return statistics.median(r[key] for r in runs if r["model"] == name and r["k"] == k
                                 and r["profiled"] == profiled)

    summary = {name: {str(k): {"wall_s": median(name, k, False, "wall_s"),
                               "profiled_wall_s": median(name, k, True, "wall_s"),
                               "device_busy_s": median(name, k, True, "device_busy_s"),
                               "idle_share": median(name, k, True, "idle_share"),
                               "host_keys_s": median(name, k, False, "host_keys_s"),
                               "stacked_upload_s": median(name, k, False, "stacked_upload_s")}
                       for k in (1, K)} for name in names}
    print(json.dumps({"medians": summary, "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
