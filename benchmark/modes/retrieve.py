"""Retrieval cells: a closed loop of one client through
``make_retrieval_scorer``.

Set-up builds the model with the benchmark's weights, makes the pool of
requests and the scorer (which normalizes the corpus once) and serves
``warm_requests``.  The window sends the pool's requests, cycled, each
after the last returned; a request runs from host arrays in to host arrays
out.  Every ``keep_every``-th request on average, chosen from the seed,
keeps its answer; after the window the check draws ``check_requests`` of
them from the seed and holds each served (score, id) against the plain
reference's scores of the whole corpus.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.cell import check_precision, install_weights, precision
from benchmark.harness.data import make_weights, sub_seed


def setup(run) -> None:
    cfg, tr, fam = run.config, run.traffic, run.family
    from rec_pangu_tpu_torch.serving import scorer

    model = fam.build(cfg)
    run.mark("build")
    install_weights(model, run)
    check_precision(cfg, dict(model.named_parameters()))
    run.mark("weights")
    run.pool = fam.request_pool(cfg, tr, run.seed, run.device)
    run.mark("pool")
    run.retrieve = scorer.make_retrieval_scorer(model, topk=int(tr["topk"]),
                                                normalize=bool(tr["normalize"]),
                                                device=run.device)
    for k in range(int(tr["warm_requests"])):
        run.retrieve(run.pool[k % len(run.pool)])
    run.mark("warm_requests")
    run.model = model
    run.program = {"kept": []}
    run.next = int(tr["warm_requests"])
    run.work = fam.request_work(cfg, tr)


def _kept(seed: int, r: int, every: int) -> bool:
    return sub_seed(seed, f"keep:{r}") % every == 0


def window(run, seconds: float) -> dict:
    retrieve, pool = run.retrieve, run.pool
    every = int(run.traffic["keep_every"])
    kept = run.program["kept"]
    latencies: List[float] = []
    slots: List[int] = []
    r = run.next
    run.sync()
    t0 = time.perf_counter()
    while True:
        slot = r % len(pool)
        start = time.perf_counter()
        with run.span("bench.request"):
            scores, ids = retrieve(pool[slot])
        end = time.perf_counter()
        latencies.append(end - start)
        slots.append(slot)
        if _kept(run.seed, r, every):
            kept.append((slot, scores, ids))
        r += 1
        if end - t0 >= seconds:
            break
    run.sync()
    window_s = time.perf_counter() - t0
    run.next = r
    return {"count": len(latencies), "rows": len(latencies) * int(run.traffic["batch"]),
            "window_s": window_s, "latencies": latencies, "slots": slots}


def end_to_end(run) -> dict:
    return {"serve_p95_ms": float(np.percentile(run.stats["latencies"], 95)) * 1e3,
            "serve_rows_per_s": run.stats["rows"] / run.stats["window_s"]}


def after_trace(run) -> None:
    pass


def compare(scores: np.ndarray, ids: np.ndarray, ref: torch.Tensor, k: int) -> Dict[str, float]:
    """How far served answers [B, k] lie from the reference's scores [B, V]:
    ``score_gap``, the widest gap between a served score and the reference's
    score of the served id; ``rank_gap``, the widest margin by which a served
    id's reference score lies below the reference's k-th best.  An id out of
    range or served twice in a row reads inf."""
    got = torch.from_numpy(np.asarray(ids, np.int64)).to(ref.device)
    ordered = got.sort(dim=1).values
    if (bool(((got < 0) | (got >= ref.shape[1])).any())
            or bool((ordered[:, 1:] == ordered[:, :-1]).any())):
        return {"score_gap": float("inf"), "rank_gap": float("inf")}
    at = ref.gather(1, got)
    kth = ref.topk(k, dim=1).values[:, -1:]
    served = torch.from_numpy(np.asarray(scores, np.float32)).to(ref.device)
    return {"score_gap": float((served - at).abs().max()),
            "rank_gap": float((kth - at).clamp(min=0).max())}


def sample(run) -> list:
    """The kept answers the check compares: ``check_requests`` of them drawn
    from the seed."""
    kept = run.program["kept"]
    rng = np.random.default_rng(sub_seed(run.seed, "check"))
    take = min(int(run.traffic["check_requests"]), len(kept))
    return [kept[i] for i in sorted(rng.choice(len(kept), take, replace=False))]


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def reference_scores(run, weights, items, slot: int) -> torch.Tensor:
    return run.reference.scores(weights, run.config, items, run.pool[slot],
                                bool(run.traffic["normalize"]), run.device)


def check(run) -> Dict[str, float]:
    chosen = sample(run)
    if not chosen:
        return {"score_gap": float("inf"), "rank_gap": float("inf")}
    weights = make_weights(run.reference.weight_specs(run.config), run.seed, run.device)
    items = run.reference.corpus(weights, run.config, bool(run.traffic["normalize"]))
    k = int(run.traffic["topk"])
    return worst([compare(s, i, reference_scores(run, weights, items, slot), k)
                  for slot, s, i in chosen])


def control(run) -> Dict[str, float]:
    """The reference in the program's place, in TF32 (the precision below
    the configuration's float32): its top-k of ``check_requests`` requests
    of the pool, drawn from the seed, held against the reference."""
    run.pool = run.family.request_pool(run.config, run.traffic, run.seed, run.device)
    rng = np.random.default_rng(sub_seed(run.seed, "check"))
    slots = rng.choice(len(run.pool), int(run.traffic["check_requests"]), replace=False)
    weights = make_weights(run.reference.weight_specs(run.config), run.seed, run.device)
    items = run.reference.corpus(weights, run.config, bool(run.traffic["normalize"]))
    k, out = int(run.traffic["topk"]), []
    for slot in sorted(slots):
        want = reference_scores(run, weights, items, slot)
        with precision(True):
            top, ids = reference_scores(run, weights, items, slot).topk(k, dim=1)
        out.append(compare(top.cpu().numpy(), ids.cpu().numpy(), want, k))
        del want, top, ids
    return worst(out)
