"""Rank bodies of the port's mesh tests (``test_torch_parallel.py``,
``test_torch_trainer_mesh.py``).

``spawn(body, world, workdir, **kwargs)`` starts ``world`` processes with
the spawn start method; each joins a gloo group over a ``file://`` store in
``workdir`` (``initialize_multihost(..., device="cpu")``), runs ``body(rank,
**kwargs)`` single-threaded and pickles what it returns.  The parent polls
them against a deadline: when a rank fails, or the deadline passes, it
kills every rank still running and raises with the failed ranks'
tracebacks, so a rank blocked in a collective fails one test instead of
hanging the suite.  This module imports only numpy, torch and the port: a
rank does not pay for JAX.

A body runs every check of its file and returns the arrays; the test files
hold them against the single-device runs (made in the same rank, so the
same process settings give both) and against the JAX package.
"""
import contextlib
import copy
import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

SPAWN_TIMEOUT_S = 150

F, VOCAB, DENSE, DIM, BATCH = 4, 5000, 2, 8, 256
HIDDEN = (16, 16)
LR = 1e-2
CPU = torch.device("cpu")
FROZEN_COLS = ("s1", "s2")
PRETRAINED = {"unseen": np.ones(DIM, np.float32)}  # its rows: build_pretrained_matrix's draws


def _entry(body, rank: int, world: int, store: str, out: str, kwargs: dict) -> None:
    torch.set_num_threads(1)
    try:
        from rec_pangu_tpu_torch.parallel import initialize_multihost

        initialize_multihost(f"file://{store}", world, rank, device="cpu")
        result = {"ok": body(rank, **kwargs)}
    except BaseException:  # reported to the parent, which fails the test with it
        result = {"error": traceback.format_exc()}
    with open(f"{out}.{rank}.tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(f"{out}.{rank}.tmp", f"{out}.{rank}")


def spawn(body, world: int, workdir: str, timeout: float = SPAWN_TIMEOUT_S, **kwargs) -> list:
    """Run ``body`` on ``world`` ranks, rendezvous and results in
    ``workdir``; returns each rank's result."""
    ctx = mp.get_context("spawn")
    store, out = os.path.join(workdir, "store"), os.path.join(workdir, "result")
    procs = [ctx.Process(target=_entry, args=(body, r, world, store, out, kwargs), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results = [None] * world
    errors = {}
    try:
        while len(results) - results.count(None) + len(errors) < world:
            for r in range(world):
                path = f"{out}.{r}"
                if results[r] is None and r not in errors and os.path.exists(path):
                    with open(path, "rb") as f:
                        res = pickle.load(f)
                    if "error" in res:
                        errors[r] = res["error"]
                    else:
                        results[r] = res["ok"]
                elif results[r] is None and r not in errors and not procs[r].is_alive() \
                        and not os.path.exists(path):
                    errors[r] = f"exited with code {procs[r].exitcode} and no result"
            if errors or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    if errors:
        raise RuntimeError("ranks failed:\n" + "\n".join(f"rank {r}: {e}"
                                                          for r, e in sorted(errors.items())))
    if any(r is None for r in results):
        raise RuntimeError(f"ranks {[r for r in range(world) if results[r] is None]} did not "
                           f"finish within {timeout} s")
    return results


# ----------------------------------------------------------------- inputs
def enc_dict(vocab: int = VOCAB) -> dict:
    enc = {f"s{f}": {"vocab_size": vocab} for f in range(F)}
    enc.update({f"d{d}": {"min": 0.0, "max": 1.0} for d in range(DENSE)})
    return enc


def batch(seed: int, rows: int = BATCH, tasks: int = 1, vocab: int = VOCAB) -> dict:
    rng = np.random.default_rng(seed)
    shape = (rows,) if tasks == 1 else (rows, tasks)
    return {"sparse": rng.integers(0, vocab + 1, (rows, F)).astype(np.int32),
            "dense": rng.random((rows, DENSE)).astype(np.float32),
            "label": rng.integers(0, 2, shape).astype(np.float32)}


class ArrayDataset:
    """Rows of numpy arrays, as the port's ``DataLoader`` reads them."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def __len__(self) -> int:
        return len(next(iter(self.arrays.values())))


def deepfm(drop: float = 0.0, seed: int = 1029, vocab: int = VOCAB):
    from rec_pangu_tpu_torch.models import get_model

    model = get_model("DeepFM")(enc_dict=enc_dict(vocab), embedding_dim=DIM,
                                hidden_units=HIDDEN, seed=seed)
    model.mlp.drops = [drop] * len(HIDDEN)
    return model


def weights(model) -> dict:
    return {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}


def trainer(tmp: str, tag: str, **kw):
    from rec_pangu_tpu_torch.train import RankTrainer

    return RankTrainer(device="cpu", model_ckpt_dir=os.path.join(tmp, tag), **kw)


def recorded_fit(tr, model, loader, mesh, snap=weights, **kw) -> dict:
    """``tr.fit`` with each step's loss (the global batch's under a mesh),
    ``snap(model)`` after each step (with the first table's fused-step
    moments) and the outputs of the first step."""
    inner = tr._step
    rec = {"losses": [], "after": [], "first_out": None}

    def step(b):
        out = inner(b)
        rec["losses"].append(float(out["loss"].detach()))
        s = snap(model)
        moments = getattr(tr._train_step, "moments", None)
        if moments:
            s["mu"], s["nu"] = (m.detach().clone().numpy() for m in moments[0])
        rec["after"].append(s)
        if rec["first_out"] is None:
            rec["first_out"] = {k: v.detach().numpy().copy() for k, v in out.items()
                                if k != "loss"}
        return out

    tr._step = step
    try:
        rec["metric"] = tr.fit(model, loader, mesh=mesh, log_rounds=10 ** 9, **kw)
    finally:
        del tr._step
    rec["step"] = type(tr._train_step).__name__
    return rec


@contextlib.contextmanager
def recording_grads():
    """Every gradient as the standard step's Adam first sees it (after the
    mesh's all-reduce), keyed by id(weight)."""
    from rec_pangu_tpu_torch.train import steps

    seen = []
    orig = steps.make_optimizer

    def make(params, lr, optimizer="adam"):
        opt = orig(params, lr, optimizer)
        inner = opt.step

        def step(*a, **k):
            seen.append({id(p): p.grad.detach().clone() for group in opt.param_groups
                         for p in group["params"] if p.grad is not None})
            return inner(*a, **k)

        opt.step = step
        return opt

    steps.make_optimizer = make
    try:
        yield seen
    finally:
        steps.make_optimizer = orig


def whole_table_grad(model, grads: dict) -> np.ndarray:
    """The table's gradient from ``recording_grads``, gathered over ``model``
    when the table is sharded."""
    from rec_pangu_tpu_torch.parallel.comm import gather_rows

    g = grads[id(model.embedding.table)]
    state = getattr(model, "mesh_state", None)
    if state is not None and model.embedding.row_shard is not None:
        g = gather_rows(g, state.model_group)
    return g.numpy()


# ------------------------------------------------------ test_torch_parallel
def parallel_world4(rank: int, topk: dict) -> dict:
    """A 2 x 2 and a 4 x 1 mesh: the mesh, the collectives' autograd rules,
    the row-sharded lookup and its gradient, the distributed top-k, the
    global BatchNorm, the global-row dropout hash, the mesh retrieval."""
    from rec_pangu_tpu_torch.data.encoder import FeatureSpec
    from rec_pangu_tpu_torch.eval.retrieval import get_recall_predict
    from rec_pangu_tpu_torch.models import get_model
    from rec_pangu_tpu_torch.ops import MLP
    from rec_pangu_tpu_torch.ops.dropout import RowSeed, feature_dropout
    from rec_pangu_tpu_torch.ops.embedding import FusedEmbedding
    from rec_pangu_tpu_torch.parallel import (distributed_masked_topk, distributed_topk,
                                              make_mesh, pad_to_multiple, shard_batch,
                                              shard_state, state_shardings)
    from rec_pangu_tpu_torch.parallel.comm import (all_reduce_grads, gather_rows, mean_over,
                                                   reduce_data, reduce_model)
    from rec_pangu_tpu_torch.parallel.mesh import mesh_shape
    from rec_pangu_tpu_torch.parallel.sharding import MeshState
    from rec_pangu_tpu_torch.train.trainer import masked_topk

    res = {}
    mesh22 = make_mesh(2, 2, device="cpu")
    mesh41 = make_mesh(4, 1, device="cpu")
    st = MeshState(mesh22)
    res["coords"] = (st.data_rank, st.model_rank, mesh_shape(mesh22), mesh22.mesh_dim_names,
                     mesh_shape(make_mesh(n_model=2, device="cpu")))
    try:
        make_mesh(3, 1, device="cpu")
    except ValueError as e:
        res["bad_shape"] = str(e)

    # the collectives and their stated backwards
    w = torch.tensor([1.0, 10.0, 100.0]) * (rank + 1)
    for name, fn, group in (("reduce_model", reduce_model, st.model_group),
                            ("reduce_data", reduce_data, st.data_group)):
        x = (torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)).requires_grad_()
        y = fn(x, group)
        (y * w).sum().backward()
        res[name] = (y.detach().numpy(), x.grad.numpy())
    res["gather_rows"] = gather_rows(torch.full((2, 3), float(rank)), st.data_group).numpy()
    g = [torch.full((3,), float(rank)), None]
    all_reduce_grads(g, st.data_group)
    res["all_reduce_grads"] = g[0].numpy()
    res["mean_over"] = float(mean_over(torch.tensor(float(rank)), st.data_group))

    # the row-sharded lookup over 2 x 2: each data rank its block, each
    # model rank its rows
    spec = FeatureSpec.from_enc_dict(enc_dict())
    whole = FusedEmbedding(spec, DIM, generator=torch.Generator().manual_seed(3))
    sharded = copy.deepcopy(whole)
    state = shard_state(sharded, mesh22)
    blk = shard_batch(batch(30), mesh22)
    ids = torch.from_numpy(blk["sparse"])
    got, want = sharded(ids), whole(ids)
    cot = torch.from_numpy(np.random.default_rng(40 + state.data_rank)
                           .standard_normal(tuple(got.shape)).astype(np.float32))
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    first, rows = sharded.row_shard[0], sharded.table.shape[0]
    res["lookup"] = (got.detach().numpy(), want.detach().numpy())
    res["lookup_grad"] = (sharded.table.grad.numpy(), whole.table.grad[first:first + rows].numpy())
    res["shard_rows"] = (first, rows, sharded.row_shard[1])
    res["shardings"] = state_shardings(deepfm(), mesh22)
    res["shardings_odd"] = state_shardings(
        FusedEmbedding(FeatureSpec.from_enc_dict({"s0": {"vocab_size": 4}}), 2), mesh22)

    # the distributed top-k against torch.topk on the whole table
    users, items = torch.from_numpy(topk["users"]), torch.from_numpy(topk["items"])
    seen, k = torch.from_numpy(topk["seen"]), topk["k"]
    padded = pad_to_multiple(items, 2)
    s, i = distributed_topk(mesh22, users, padded, k, num_valid=items.shape[0])
    ws, wi = torch.topk(users @ items.t(), k, dim=1)
    res["topk"] = (s.numpy(), i.numpy(), ws.numpy(), wi.numpy())
    ms, mi = distributed_masked_topk(mesh22, users, padded, seen, k, num_valid=items.shape[0])
    want_mi = masked_topk(users, items, torch.arange(users.shape[0]), seen, k)
    res["masked_topk"] = (ms.numpy(), mi.numpy(), want_mi.numpy())

    # BatchNorm on the global batch's statistics and dropout on global rows,
    # over 4 x 1: the blocks' summed objective against the whole batch's
    mlp_whole = MLP(12, (16, 8), output_dim=1, dropout_rates=0.3, batch_norm=True,
                    generator=torch.Generator().manual_seed(5))
    mlp = copy.deepcopy(mlp_whole)
    bn_state = shard_state(mlp, mesh41)
    rng = np.random.default_rng(50)
    x = torch.from_numpy(rng.standard_normal((64, 12)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((64, 1)).astype(np.float32))
    seed = 1234
    y_whole = mlp_whole(x, train=True, seed=seed)
    (y_whole * cot).sum().backward()
    b = 64 // 4
    lo = bn_state.data_rank * b
    with bn_state.running(True, lo):
        y = mlp(x[lo:lo + b], train=True, seed=RowSeed(seed, lo))
        (y * cot[lo:lo + b]).sum().backward()
    for p in mlp.parameters():
        dist.all_reduce(p.grad, group=bn_state.data_group)

    def stats(m):
        return [t.numpy().copy() for bn in m.bn for t in (bn.running_mean, bn.running_var)]

    res["bn"] = {
        "train_out": (gather_rows(y.detach(), bn_state.data_group).numpy(),
                      y_whole.detach().numpy()),
        "stats": (stats(mlp), stats(mlp_whole)),
        "grads": ([p.grad.numpy() for p in mlp.parameters()],
                  [p.grad.numpy() for p in mlp_whole.parameters()]),
        "eval_out": (mlp(x, train=False).detach().numpy(),
                     mlp_whole(x, train=False).detach().numpy())}
    ones = torch.ones(64, 5)
    res["row_seed"] = (feature_dropout(ones[lo:lo + b], 0.5, RowSeed(seed, lo), (600, 0)).numpy(),
                       feature_dropout(ones, 0.5, seed, (600, 0))[lo:lo + b].numpy())

    # retrieval over the mesh: 301 items (odd: a padding row per shard pair)
    model = get_model("YotubeDNN")(enc_dict={"item_id": {"vocab_size": 301}},
                                   config={"embedding_dim": 16, "max_length": 10,
                                           "item_col": "item_id"}, seed=7)
    rng = np.random.default_rng(60)
    loader = []
    for start in range(0, 96, 32):
        lens = rng.integers(1, 11, 32)
        mask = (np.arange(10)[None, :] < lens[:, None]).astype(np.float32)
        loader.append({"hist_item_list": (rng.integers(1, 301, (32, 10)) * mask).astype(np.int32),
                       "hist_mask_list": mask,
                       "user": np.array([f"u{start + j}" for j in range(32)], dtype=object)})
    res["recall"] = (get_recall_predict(model, loader, topn=20, mesh=mesh22),
                     get_recall_predict(model, loader, topn=20))
    return res


# --------------------------------------------------- test_torch_trainer_mesh
def _ngcf(ds, seed: int = 11):
    from rec_pangu_tpu_torch.models import get_model

    return get_model("NGCF")(num_user=ds.num_user, num_item=ds.num_item, embedding_dim=8,
                             hidden_size=(8, 8), dropout=0.1, g=ds.generate_graph("cpu"),
                             seed=seed)


def graph_datasets():
    from rec_pangu_tpu_torch.data import GeneralGraphDataset

    rng = np.random.default_rng(70)
    users, items = 40, 61
    u = rng.integers(0, users, 600)
    i = rng.integers(0, items, 600)
    train = GeneralGraphDataset({"user_id": u[:500], "item_id": i[:500]}, users, items)
    test = GeneralGraphDataset({"user_id": u[500:], "item_id": i[500:]}, users, items,
                               phase="test")
    return train, test


def trainer_world2(rank: int, tmp: str, jax_init: dict) -> dict:
    """A 2 x 1 and a 1 x 2 mesh: the data-parallel fused fit against the
    single-device one (dropout on) and against JAX's (JAX's initial
    weights, dropout off), the 1 x 2 sharded lookup, standard step and
    evaluation, partial batches, BatchNorm, GraphTrainer, BenchmarkTrainer."""
    from rec_pangu_tpu_torch.convert import jax_variables, load_jax_variables
    from rec_pangu_tpu_torch.data import DataLoader
    from rec_pangu_tpu_torch.models import get_model
    from rec_pangu_tpu_torch.parallel import make_mesh, shard_state
    from rec_pangu_tpu_torch.train import BenchmarkTrainer, GraphTrainer

    tmp = os.path.join(tmp, f"rank{rank}")
    res = {}
    mesh21 = make_mesh(2, 1, device="cpu")
    mesh12 = make_mesh(1, 2, device="cpu")
    batches = [batch(s) for s in (10, 11, 12)]

    # the data-parallel fused step against the single device, dropout on
    for tag, mesh in (("dp", mesh21), ("single", None)):
        res[f"fused_{tag}"] = recorded_fit(trainer(tmp, f"fused_{tag}"), deepfm(0.2), batches,
                                           mesh, epoch=1, lr=LR)

    # the same fit from JAX's initial weights, dropout off, against JAX's
    model = deepfm(vocab=jax_init["vocab"])
    load_jax_variables(model, {"params": jax_init["params"]})
    res["jax_dp"] = recorded_fit(trainer(tmp, "jax_dp"), model, jax_init["batches"], mesh21,
                                 snap=lambda m: {"params": jax_variables(m)["params"]},
                                 epoch=1, lr=jax_init["lr"])

    # 1 x 2: the sharded lookup, the standard step's first table gradient,
    # evaluate_model after three epochs
    whole = deepfm()
    sharded = copy.deepcopy(whole)
    shard_state(sharded, mesh12)
    ids = torch.from_numpy(batches[0]["sparse"])
    with torch.no_grad():
        res["tp12_lookup"] = (sharded.embedding(ids).numpy(), whole.embedding(ids).numpy())
    leg = _tp_leg(tmp, "tp12", mesh12, batches)
    del leg["tr"], leg["model"]
    res["tp12"] = leg

    # a partial batch that does not divide the data axis: 91 rows in 64s
    arrays = batch(80, rows=91)
    for tag, mesh in (("dp", mesh21), ("single", None)):
        tr = trainer(tmp, f"partial_{tag}")
        model = deepfm()
        loader = DataLoader(ArrayDataset(arrays), batch_size=64, shuffle=True, seed=2)
        tr.fit(model, loader, epoch=2, lr=LR, mesh=mesh, log_rounds=10 ** 9)
        res[f"partial_{tag}"] = {
            "weights": weights(model),
            "metric": tr.evaluate_model(model, DataLoader(ArrayDataset(arrays), batch_size=64)),
            "preds": tr.predict_dataloader(model, DataLoader(ArrayDataset(arrays),
                                                             batch_size=64))}

    # per-host input: a loader sharded over the data ranks gives each rank
    # its own rows, the global loader the same rows a step in blocks
    arrays = batch(85, rows=256)
    host = {}
    for tag, loader in (("sharded", DataLoader(ArrayDataset(arrays), batch_size=64,
                                               shard_rank=rank, num_shards=2)),
                        ("global", DataLoader(ArrayDataset(arrays), batch_size=128))):
        tr = trainer(tmp, f"host_{tag}")
        model = deepfm()
        metric = tr.fit(model, loader, epoch=1, lr=LR, mesh=mesh21, log_rounds=10 ** 9)
        host[tag] = {"weights": weights(model), "metric": metric, "steps": tr.step}
    try:
        trainer(tmp, "host_bad").fit(deepfm(), DataLoader(ArrayDataset(arrays), batch_size=64,
                                                          shard_rank=1 - rank, num_shards=2),
                                     epoch=1, mesh=mesh21)
    except ValueError as e:
        host["refused"] = str(e)
    res["host_input"] = host

    # BatchNorm (ShareBottom's towers, dropout 0.2) on the global batch
    bn_batches = [batch(s, tasks=2) for s in (90, 91)]
    for tag, mesh in (("dp", mesh21), ("single", None)):
        model = get_model("ShareBottom")(enc_dict=enc_dict(), embedding_dim=DIM,
                                         hidden_units=(16, 8))
        rec = recorded_fit(trainer(tmp, f"bn_{tag}", num_task=2), model, bn_batches, mesh,
                           snap=lambda m: {k: v.detach().clone().numpy()
                                           for k, v in m.state_dict().items() if "running" in k},
                           epoch=1, lr=LR)
        res[f"bn_{tag}"] = {"out": rec["first_out"], "stats": rec["after"][0],
                            "losses": rec["losses"], "step": rec["step"]}

    # GraphTrainer: fit under 2 x 1, evaluate_model under 1 x 2
    for tag, mesh in (("dp", mesh21), ("single", None)):
        train_ds, test_ds = graph_datasets()
        model = _ngcf(train_ds)
        gt = GraphTrainer(model_ckpt_dir=os.path.join(tmp, f"graph_{tag}"), device="cpu")
        losses = []
        inner = gt._step

        def step(b, inner=inner, losses=losses):
            out = inner(b)
            losses.append(float(out["loss"].detach()))
            return out

        gt._step = step
        gt.fit(model, train_ds, epoch=2, lr=1e-2, batch_size=32, mesh=mesh)
        res[f"graph_fit_{tag}"] = {"losses": losses, "weights": weights(model)}
    train_ds, test_ds = graph_datasets()
    model = _ngcf(train_ds)
    gt = GraphTrainer(model_ckpt_dir=os.path.join(tmp, "graph_eval"), device="cpu")
    single = gt.evaluate_model(model, train_ds, test_ds, topN=10)
    shard_state(model, mesh12)
    res["graph_eval"] = (gt.evaluate_model(model, train_ds, test_ds, topN=10), single)

    # BenchmarkTrainer passes the mesh on; global rank 0 alone writes its CSV
    loader = DataLoader(ArrayDataset(batch(95, rows=128)), batch_size=64)
    path = os.path.join(tmp, "bench.csv")
    df = BenchmarkTrainer(["DeepFM"], model_ckpt_dir=os.path.join(tmp, "bench"),
                          benchmark_res_path=path).run(
        loader, loader, loader, enc_dict(), epoch=1, lr=LR, device="cpu", mesh=mesh21,
        model_kwargs={"DeepFM": {"embedding_dim": DIM, "hidden_units": HIDDEN}})
    res["benchmark"] = {"rows": len(df), "columns": list(df.columns),
                        "csv": os.path.exists(path)}
    return res


def _tp_leg(tmp: str, tag: str, mesh, batches) -> dict:
    """The standard step's first table gradient under ``mesh`` (gathered)
    and on the single device, then evaluate_model and predict_dataloader
    after three epochs of each."""
    from rec_pangu_tpu_torch.train.steps import StandardStep

    out = {}
    with recording_grads() as seen:
        single = deepfm()
        step = StandardStep(single, LR, 1, generator=torch.Generator().manual_seed(0))
        step(single.upload_batch(batches[0], CPU, train=True), 0)
    out["grad_single"] = whole_table_grad(single, seen[0])
    with recording_grads() as seen:
        tr = trainer(tmp, tag)
        model = deepfm()
        tr.fit(model, batches, epoch=3, lr=LR, mesh=mesh, log_rounds=10 ** 9)
    out["grad_mesh"] = whole_table_grad(model, seen[0])
    out["step"] = type(tr._train_step).__name__
    out["metric_mesh"] = tr.evaluate_model(model, batches)
    out["preds_mesh"] = tr.predict_dataloader(model, batches)
    single_tr = trainer(tmp, f"{tag}_single")
    single = deepfm()
    single_tr.fit(single, batches, epoch=3, lr=LR, log_rounds=10 ** 9)
    out["metric_single"] = single_tr.evaluate_model(single, batches)
    out["preds_single"] = single_tr.predict_dataloader(single, batches)
    out["tr"], out["model"] = tr, model
    return out


def trainer_world4(rank: int, tmp: str, jax_ckpt: str) -> dict:
    """A 2 x 2 mesh: the sharded lookup, the standard step's first table
    gradient and evaluate_model against the single device; a save_all
    checkpoint of the mesh run (whole tables, written by rank 0); a JAX
    checkpoint resumed under the mesh against the single device's resume."""
    from rec_pangu_tpu_torch.parallel import make_mesh, shard_batch, shard_state

    res = {}
    mesh22 = make_mesh(2, 2, device="cpu")
    batches = [batch(s) for s in (20, 21, 22)]
    whole = deepfm()
    sharded = copy.deepcopy(whole)
    shard_state(sharded, mesh22)
    ids = torch.from_numpy(shard_batch(batches[0], mesh22)["sparse"])
    with torch.no_grad():
        res["lookup"] = (sharded.embedding(ids).numpy(), whole.embedding(ids).numpy())
    leg = _tp_leg(os.path.join(tmp, f"rank{rank}"), "tp22", mesh22, batches)
    tr, model = leg.pop("tr"), leg.pop("model")
    res["tp22"] = leg
    ckpt_dir = os.path.join(tmp, "ckpt22")
    res["ckpt"] = tr.save_all(model, enc_dict(), ckpt_dir)
    res["ckpt_weights"] = weights(model)  # the rank's blocks after the save

    # frozen pretrained rows of fields s1 and s2 (rows 5,001 to 10,001 in
    # model rank 0's block, 10,002 to 15,002 in rank 1's) stay as written
    # through a 2 x 2 fit
    from rec_pangu_tpu_torch.parallel.sharding import whole_variables

    tr = trainer(os.path.join(tmp, f"rank{rank}"), "frozen")
    model = deepfm()
    for col in FROZEN_COLS:
        tr.set_pretrained_weights(model, col, PRETRAINED, trainable=False)
    tr.fit(model, batches, epoch=1, lr=LR, mesh=mesh22, log_rounds=10 ** 9)
    res["frozen"] = {"table": whole_variables(model)["params"]["FusedEmbedding_0"]["table"],
                     "step": type(tr._train_step).__name__}

    # a JAX save_all resumed under the mesh and on the single device (the
    # standard step both: the mesh's model axis takes it)
    resume_batches = [batch(s) for s in (30, 31)]
    for tag, mesh in (("mesh", mesh22), ("single", None)):
        tr = trainer(os.path.join(tmp, f"rank{rank}"), f"resume_{tag}")
        model = deepfm()
        prev = os.environ.get("REC_PANGU_TPU_FUSED_ADAM")
        os.environ["REC_PANGU_TPU_FUSED_ADAM"] = "0"
        try:
            tr.fit(model, resume_batches, epoch=1, lr=LR, mesh=mesh, resume_from=jax_ckpt,
                   log_rounds=10 ** 9)
        finally:
            if prev is None:
                del os.environ["REC_PANGU_TPU_FUSED_ADAM"]
            else:
                os.environ["REC_PANGU_TPU_FUSED_ADAM"] = prev
        res[f"resume_{tag}"] = {"params": whole_variables(model)["params"], "step": tr.step}
    return res
