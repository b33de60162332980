"""Training cells: the trainer as ``fit`` runs it.

Set-up builds the model with the benchmark's weights, makes the pool of
host batches, lets ``fit`` (zero epochs) build the fused step, then drives
the trainer's own ``_step`` through the first ``check_steps`` batches of the
pool, recording each step's loss, every leaf's first gradient (from Adam's
first moment after step 1, m / (1 - b1)) and every leaf's change after the
last of them; ``warm_steps`` more steps follow.  The window hands that same
trainer the rest of the pool, cycled.  The check runs the plain reference
through the same batches from the same weights and compares.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict

import torch

from benchmark.harness.cell import Refused, check_precision, install_weights, precision
from benchmark.harness.data import make_weights
from benchmark.reference.common import ADAM_B1, leaf_gaps, norms, relative_gap, step_seeds

# leaves whose reference gradient is under this share of the median leaf's move
# under Adam by rounding alone, and are left out of the change
STILL = 1e-3


def moments(step, model, which: int) -> Dict[str, torch.Tensor]:
    """Adam's first (``which`` 0) or second (1) moment of every parameter
    the step updates, by name: the dense optimizer's ``exp_avg`` or
    ``exp_avg_sq`` and the sequence fused step's item-table moment."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    if step.optimizer is not None:
        for p, state in step.optimizer.state.items():
            out[names[id(p)]] = state[("exp_avg", "exp_avg_sq")[which]]
    out[names[id(model.item_emb.table)]] = (step.mu, step.nu)[which]
    return out


def setup(run) -> None:
    cfg, tr, fam = run.config, run.traffic, run.family
    model = fam.build(cfg)
    run.mark("build")
    install_weights(model, run)
    run.mark("weights")
    run.pool = fam.train_pool(cfg, tr, run.seed, run.device)
    run.mark("pool")
    trainer = fam.make_trainer(run.workdir, run.device)
    trainer.fit(model, run.pool, epoch=0, lr=float(cfg["lr"]), device=run.device,
                seed=run.fit_seed)
    run.mark("fit")
    step = trainer._train_step
    if not getattr(step, "fused", False):
        raise Refused(f"the fused step did not engage: the trainer took {type(step).__name__}")
    model.train()
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    losses, grads = [], {}
    for k in range(int(tr["check_steps"])):
        losses.append(float(trainer._step(run.pool[k])["loss"].detach()))
        if k == 0:
            m1, m2 = moments(step, model, 0), moments(step, model, 1)
            check_precision(cfg, {**params, **{f"{n}.m": t for n, t in m1.items()},
                                  **{f"{n}.v": t for n, t in m2.items()}})
            grads = norms({n: m1[n] / (1.0 - ADAM_B1) if n in m1
                           else torch.zeros(()) for n in params})
    change = norms({k: p.detach() - start[k] for k, p in params.items()})
    del start
    run.program = {"losses": losses, "grad_norms": grads, "change_norms": change}
    run.mark("checked_steps")
    first = int(tr["check_steps"])
    for k in range(first, first + int(tr["warm_steps"])):
        trainer._step(run.pool[k])
    run.sync()
    run.mark("warm_steps")
    run.next = first + int(tr["warm_steps"])
    run.model, run.trainer = model, trainer
    run.work = fam.train_work(cfg, tr)


def window(run, seconds: float) -> dict:
    trainer, pool = run.trainer, run.pool
    i, steps = run.next, 0
    run.sync()
    t0 = time.perf_counter()
    while True:
        with run.span("bench.step"):
            trainer._step(pool[i % len(pool)])
        i, steps = i + 1, steps + 1
        if time.perf_counter() - t0 >= seconds:
            break
    run.sync()
    window_s = time.perf_counter() - t0
    slots = [j % len(pool) for j in range(run.next, i)]
    run.next = i
    return {"count": steps, "rows": steps * int(run.traffic["batch"]), "window_s": window_s,
            "slots": slots}


def end_to_end(run) -> dict:
    return {"train_examples_per_s": run.stats["rows"] / run.stats["window_s"]}


UPLOAD_SPAN_S = 0.25  # host-clock spans shorter than this are summed over more uploads


def after_trace(run) -> None:
    """The host batch layer alone: ``upload_batch`` (id check and copy) and a
    synchronize, over the pool, repeated until the span lasts UPLOAD_SPAN_S."""
    model, trainer = run.model, run.trainer
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < UPLOAD_SPAN_S:
        for batch in run.pool:
            model.upload_batch(trainer._host_inputs(batch), run.device, train=True)
            run.sync()
            n += 1
    run.upload_s = (time.perf_counter() - t0) / n


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The gaps of a training run's readings from the reference's: the worst
    step's relative loss gap, and the worst leaf's gap of first-gradient norm
    and of change norm, each over the larger of the reference's norm of that
    leaf and of the median leaf.  Leaves whose reference gradient is under
    STILL of the median leaf's are left out of the change."""
    loss = max(relative_gap(a, b) for a, b in zip(got["losses"], want["losses"]))
    grad = leaf_gaps(got["grad_norms"], want["grad_norms"], want["grad_norms"])
    median = statistics.median(want["grad_norms"].values())
    moved = [k for k, g in want["grad_norms"].items() if g >= STILL * median]
    change = leaf_gaps(got["change_norms"], want["change_norms"], moved)
    return {"loss_gap": loss, "grad_gap": max(grad.values()),
            "change_gap": max(change.values())}


def reference_readings(run, batches=None) -> dict:
    """The reference's readings of the run's checked steps, from the run's
    weights (or through ``batches`` in their place)."""
    n = int(run.traffic["check_steps"])
    weights = make_weights(run.reference.weight_specs(run.config), run.seed, run.device)
    out = run.reference.train_steps(run.config, weights, batches or run.pool[:n],
                                    step_seeds(run.fit_seed, n), run.device)
    del weights
    return out


def check(run) -> Dict[str, float]:
    return compare(run.program, reference_readings(run))


def control(run) -> Dict[str, float]:
    """The reference in the program's place, in TF32 (the precision below
    the configuration's float32), held against the reference."""
    run.pool = run.family.train_pool(run.config, run.traffic, run.seed, run.device)
    want = reference_readings(run)
    with precision(True):
        got = reference_readings(run)
    return compare(got, want)


def fault_half_batch(run) -> Dict[str, float]:
    """The reference in the program's place with half of each batch left
    out, the mean taken over the rest, held against the reference."""
    run.pool = run.family.train_pool(run.config, run.traffic, run.seed, run.device)
    n = int(run.traffic["check_steps"])
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in run.pool[:n]]
    return compare(reference_readings(run, half), reference_readings(run))
