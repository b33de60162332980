"""Rank bodies of ``test_torch_seq_mesh.py``: ``SequenceTrainer.fit(mesh=...)``
for the 18 sequence models, spawned with ``_torch_mesh_ranks.spawn`` (gloo
ranks on the CPU, single-threaded).  This module imports numpy, torch and
the port only.

Each body returns arrays for the test file to hold against the port's
single-device fits (made in the same ranks) and against the JAX package.
"""
import os

import numpy as np
import torch

VOCAB, L, DIM, BATCH = 64, 8, 8, 16   # an even table: it row-shards over 2 model ranks
LR = 1e-2
BASE = {"embedding_dim": DIM, "max_length": L, "item_col": "item_id"}
BERT = {"n_layers": 1, "n_heads": 2, "inner_size": 16, "hidden_dropout_prob": 0.2,
        "attn_dropout_prob": 0.2}
# each model at a few layers and narrow widths, its dropout sites on
ZOO = (("SASRec", {**BASE, **BERT}),
       ("GRU4Rec", BASE),
       ("YotubeDNN", BASE),
       ("NARM", {**BASE, "n_layers": 1, "hidden_size": 8, "dropout_probs": [0.2, 0.2]}),
       ("STAMP", {**BASE, "feat_drop": 0.2}),
       ("NextItNet", {**BASE, "dilations": [1, 2], "kernel_size": 3, "feat_drop": 0.2}),
       ("SRGNN", BASE),
       ("GCSAN", {**BASE, **BERT}),
       ("NISER", {**BASE, "item_dropout": 0.2}),
       ("ComirecSA", {**BASE, "K": 2}),
       ("ComirecDR", {**BASE, "K": 2}),
       ("MIND", {**BASE, "K": 2}),
       ("SINE", {**BASE, "prototype_size": 10, "interest_size": 2}),
       ("Re4", {**BASE, "K": 2}),
       ("CMI", {**BASE, "K": 4, "num_layers": 1, "dropout_prob": 0.2}),
       ("IOCRec", {**BASE, "K": 2, "num_blocks": 1, "num_heads": 2, "ffn_hidden": 16,
                   "hidden_dropout": 0.2, "attn_dropout": 0.2}),
       ("ContraRec", BASE),
       ("CLRec", BASE))
NAMES = tuple(name for name, _ in ZOO)


def enc_dict(vocab: int = VOCAB) -> dict:
    return {"item_id": {"vocab_size": vocab}}


def seq_batch(seed: int, rows: int = BATCH, vocab: int = VOCAB, length: int = L) -> dict:
    """Histories of 1..L items (0-padded at the end), their masks and
    targets, from ``seed``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, length + 1, rows)
    mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.float32)
    hist = (rng.integers(1, vocab, (rows, length)) * mask).astype(np.int32)
    return {"hist_item_list": hist, "hist_mask_list": mask,
            "target_item": rng.integers(1, vocab, rows).astype(np.int32)}


def model(name: str, config: dict, seed: int = 11, vocab: int = VOCAB):
    from rec_pangu_tpu_torch.models import get_model

    return get_model(name)(enc_dict=enc_dict(vocab), config=dict(config), seed=seed)


def params(m) -> dict:
    """{flax path: array} of the model's weights, whole tables gathered (a
    collective on a sharded model: every rank calls it)."""
    from rec_pangu_tpu_torch.parallel.sharding import whole_variables

    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out["/".join(prefix + (k,))] = np.array(v, copy=True)

    walk(whole_variables(m)["params"], ())
    return out


def trainer(tmp: str, tag: str):
    from rec_pangu_tpu_torch.train import SequenceTrainer

    return SequenceTrainer(device="cpu", model_ckpt_dir=os.path.join(tmp, tag))


def recorded_fit(tr, m, batches, mesh, **kw) -> dict:
    """``tr.fit`` with each step's loss (the global batch's under a mesh)
    and the weights after the last step."""
    inner = tr._step
    losses = []

    def step(b):
        out = inner(b)
        losses.append(float(out["loss"].detach()))
        return out

    tr._step = step
    try:
        tr.fit(m, batches, epoch=1, lr=LR, mesh=mesh, log_rounds=10 ** 9, **kw)
    finally:
        del tr._step
    return {"losses": losses, "params": params(m), "step": type(tr._train_step).__name__}


def _zoo_fits(rank: int, tmp: str, mesh, tag: str, res: dict) -> None:
    """Every model's fit under ``mesh`` on two batches, and (half the
    models on each rank) the single-device fit of the same batches."""
    for i, (name, config) in enumerate(ZOO):
        batches = [seq_batch(100 + 2 * i + s) for s in range(2)]
        res[f"{name}/{tag}"] = recorded_fit(trainer(tmp, f"{name}_{tag}"), model(name, config),
                                            [dict(b) for b in batches], mesh, seed=7)
        if tag == "dp" and i % 2 == rank:
            res[f"{name}/single"] = recorded_fit(trainer(tmp, f"{name}_single"),
                                                 model(name, config),
                                                 [dict(b) for b in batches], None, seed=7)


def _first_row_masks(rank: int) -> dict:
    """K4f's and K6f's plain versions on a block at ``first = r * b`` against
    rows r*b.. of the whole batch's (dropout 0.5, CPU)."""
    from rec_pangu_tpu_torch.ops.kernels import fused_encoder as fe
    from rec_pangu_tpu_torch.ops.kernels import global_attn as ga
    from rec_pangu_tpu_torch.ops.sequence_enc import TransformerEncoder

    g = torch.Generator().manual_seed(5)
    n, b = 8, 4
    x = torch.randn(n, L, DIM, generator=g)
    kv = torch.rand(n, L, generator=g) < 0.8
    enc = TransformerEncoder(DIM, 2, 2, 16, 0.5, 0.5, "relu", 1e-12, g)
    packed = [t.detach() for t in enc.packed()]
    whole = fe.fused_encoder_reference(x, kv, packed, 2, True, "relu", 1e-12, True, 0.5, 0.5, 9)
    lo = rank * b
    block = fe.fused_encoder_reference(x[lo:lo + b], kv[lo:lo + b], packed, 2, True, "relu",
                                       1e-12, True, 0.5, 0.5, 9, first=lo)
    gp = [torch.randn(DIM, DIM, generator=g), torch.randn(DIM, generator=g),
          torch.randn(DIM, DIM, generator=g), torch.randn(DIM, generator=g),
          torch.randn(L, DIM, generator=g)]
    gwhole = ga.global_attn_reference(x, gp, True, 0.5, 9)
    gblock = ga.global_attn_reference(x[lo:lo + b], gp, True, 0.5, 9, first=lo)
    return {"encoder": (block.numpy(), whole[lo:lo + b].numpy()),
            "global_attn": (gblock.numpy(), gwhole[lo:lo + b].numpy())}


def _host_keys(rank: int, mesh) -> dict:
    """The host keys a mesh step uploads on this rank against the rows the
    single-device trainer draws for the whole batch."""
    from rec_pangu_tpu_torch.parallel.sharding import MeshState

    state = MeshState(mesh)
    out = {}
    for name in ("IOCRec", "CMI", "CLRec", "SRGNN"):
        config = dict(ZOO)[name]
        batch = seq_batch(300)
        single, meshed = trainer("/nonexistent", "s"), trainer("/nonexistent", "m")
        single.model = model(name, config)
        meshed.model = model(name, config)
        want = single._attach_host_keys(dict(batch))
        block, split, first = meshed._block(meshed._attach_host_keys(dict(batch)), state)
        # a sharded loader's batch: this rank's rows only, the draws gathered
        presplit = trainer("/nonexistent", "p")
        presplit.model, presplit._fit_device = model(name, config), torch.device("cpu")
        own = {k: v[first:first + len(v) // state.n_data] for k, v in batch.items()}
        out[name] = {"block": block, "want": want, "split": split, "first": first,
                     "presplit": presplit._attach_host_keys(own, state)}
    return out


def _item_lookup_and_ce(rank: int, mesh) -> dict:
    """The row-sharded ItemEmbedding lookup against the whole table's, and
    the row-sharded softmax CE and K-max CE (loss, user gradient, table
    gradient gathered) against the whole table's, at a 1 x 2 mesh."""
    import copy

    from rec_pangu_tpu_torch.ops.embedding import ItemEmbedding
    from rec_pangu_tpu_torch.ops.softmax_ce import (fused_multimax_softmax_ce_padded,
                                                    fused_softmax_ce_padded)
    from rec_pangu_tpu_torch.parallel import shard_state
    from rec_pangu_tpu_torch.parallel.comm import gather_rows

    whole = ItemEmbedding(VOCAB - 4, DIM, generator=torch.Generator().manual_seed(3))
    sharded = copy.deepcopy(whole)
    state = shard_state(sharded, mesh)
    ids = torch.from_numpy(seq_batch(310)["hist_item_list"])
    res = {"lookup": (sharded(ids).detach().numpy(), whole(ids).detach().numpy()),
           "rows": sharded.row_shard}
    rng = np.random.default_rng(320)
    users = torch.from_numpy(rng.standard_normal((BATCH, DIM)).astype(np.float32))
    users3 = torch.from_numpy(rng.standard_normal((BATCH, 3, DIM)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, VOCAB - 4, BATCH).astype(np.int32))
    pos[0] = 0  # a target of 0: no gradient
    pos[1] = pos[2]  # a repeated target
    from rec_pangu_tpu_torch.ops.softmax_ce import (sharded_multimax_softmax_ce,
                                                    sharded_softmax_ce)

    for name, u0, full, part in (("ce", users, fused_softmax_ce_padded, sharded_softmax_ce),
                                 ("multimax", users3, fused_multimax_softmax_ce_padded,
                                  sharded_multimax_softmax_ce)):
        uw, us = u0.clone().requires_grad_(), u0.clone().requires_grad_()
        tw = whole.table.detach().clone().requires_grad_()
        ts = sharded.table.detach().clone().requires_grad_()
        lw = full(uw, tw, pos, whole.vocab_size)
        ls = part(us, ts, pos, sharded.row_shard[0], whole.vocab_size, state.model_group)
        lw.backward()
        ls.backward()
        res[name] = {"loss": (float(ls), float(lw)), "du": (us.grad.numpy(), uw.grad.numpy()),
                     "dtable": (gather_rows(ts.grad, state.model_group).numpy(),
                                tw.grad.numpy())}
    return res


def seq_world2(rank: int, tmp: str, jax_init: dict) -> dict:
    """A 2 x 1 and a 1 x 2 mesh: every model's mesh fit against the single
    device's (dropout on), SASRec, GRU4Rec and SRGNN from JAX's initial
    weights with dropout off (against JAX's mesh fit), the first-row
    dropout masks, the host keys, the sharded lookup and CEs,
    evaluate_model under both meshes and a mesh checkpoint."""
    from rec_pangu_tpu_torch.convert import load_jax_variables
    from rec_pangu_tpu_torch.parallel import make_mesh

    tmp = os.path.join(tmp, f"rank{rank}")
    res = {}
    mesh21 = make_mesh(2, 1, device="cpu")
    mesh12 = make_mesh(1, 2, device="cpu")
    _zoo_fits(rank, tmp, mesh21, "dp", res)
    _zoo_fits(rank, tmp, mesh12, "tp", res)

    # from JAX's initial weights, dropout off, against JAX's fit under (2, 1)
    for name, leg in jax_init.items():
        m = model(name, leg["config"], vocab=leg["vocab"])
        load_jax_variables(m, {"params": leg["params"]})
        res[f"jax/{name}"] = recorded_fit(trainer(tmp, f"jax_{name}"), m,
                                          [dict(b) for b in leg["batches"]], mesh21,
                                          seed=leg["seed"])

    res["first_row"] = _first_row_masks(rank)
    res["host_keys"] = _host_keys(rank, mesh21)
    res["sharded_ops"] = _item_lookup_and_ce(rank, mesh12)
    res["eval"] = _eval_and_ckpt(rank, tmp, (("dp", mesh21), ("tp", mesh12)))
    return res


def b_targets(seed: int) -> np.ndarray:
    return seq_batch(seed, vocab=EVAL_VOCAB)["target_item"]


class SeqDataset:
    """A sequence loader's dataset as ``evaluate_model`` reads it."""

    def __init__(self, gd: dict):
        self.gd = gd

    def get_test_gd(self) -> dict:
        return self.gd


class SeqLoader(list):
    """Batches with a ``dataset`` attribute."""

    def __init__(self, batches, dataset):
        super().__init__(batches)
        self.dataset = dataset


EVAL_VOCAB = 256  # evaluate_model ranks the top 200 items


def eval_loader(seed: int = 400, batches: int = 2) -> SeqLoader:
    out, gd = [], {}
    for j in range(batches):
        b = seq_batch(seed + j, vocab=EVAL_VOCAB)
        users = [f"u{j}_{i}" for i in range(BATCH)]
        b = {"hist_item_list": b["hist_item_list"], "hist_mask_list": b["hist_mask_list"],
             "user": np.array(users, dtype=object)}
        gd.update({u: [int(t)] for u, t in zip(users, b_targets(seed + j))})
        out.append(b)
    return SeqLoader(out, SeqDataset(gd))


def _eval_and_ckpt(rank: int, tmp: str, meshes) -> dict:
    """SASRec and ComirecSA (a multi-interest model's merged lists) fit two
    epochs on the single device and under each mesh with a valid loader
    (evaluate_model each epoch, checkpoints, log.csv), then evaluate_model;
    and the single device's trained weights sharded over each mesh
    (``same_weights``): its metrics and top-200 lists."""
    import copy

    from rec_pangu_tpu_torch.eval.retrieval import get_recall_predict
    from rec_pangu_tpu_torch.parallel import shard_state

    out = {}
    train = [seq_batch(500 + s, vocab=EVAL_VOCAB) for s in range(2)]

    def fit(name, tag, mesh):
        tr = trainer(tmp, f"eval_{name}_{tag}")
        m = model(name, dict(ZOO)[name], vocab=EVAL_VOCAB)
        tr.fit(m, [dict(b) for b in train], eval_loader(), epoch=2, lr=LR, mesh=mesh,
               log_rounds=10 ** 9, seed=7)
        return tr, m, {"metric": tr.evaluate_model(m, eval_loader(), topk_list=[5, 10]),
                       "params": params(m),
                       "ckpt": os.path.join(tr.model_ckpt_dir, "model_e_2.ckpt"),
                       "log": os.path.exists(os.path.join(tr.model_ckpt_dir, "log.csv"))}

    for name in ("SASRec", "ComirecSA"):
        tr, single, out[f"{name}/single"] = fit(name, "single", None)
        single_preds = get_recall_predict(single, eval_loader(), topn=200)
        for tag, mesh in meshes:
            _, _, leg = fit(name, tag, mesh)
            sharded = copy.deepcopy(single)
            shard_state(sharded, mesh)
            leg["same_weights"] = {
                "metric": tr.evaluate_model(sharded, eval_loader(), topk_list=[5, 10]),
                "single_metric": out[f"{name}/single"]["metric"],
                "preds": get_recall_predict(sharded, eval_loader(), topn=200, mesh=mesh),
                "single_preds": single_preds}
            out[f"{name}/{tag}"] = leg
    return out


def seq_world4(rank: int, tmp: str) -> dict:
    """A 2 x 2 mesh: SASRec's fit (the standard step, the row-sharded item
    table, dropout on) against the single device's."""
    from rec_pangu_tpu_torch.parallel import make_mesh

    tmp = os.path.join(tmp, f"rank{rank}")
    mesh22 = make_mesh(2, 2, device="cpu")
    config = dict(ZOO)["SASRec"]
    batches = [seq_batch(600 + s) for s in range(2)]
    res = {"mesh": recorded_fit(trainer(tmp, "sasrec22"), model("SASRec", config),
                                [dict(b) for b in batches], mesh22, seed=7)}
    if rank == 0:
        res["single"] = recorded_fit(trainer(tmp, "sasrec_single"), model("SASRec", config),
                                     [dict(b) for b in batches], None, seed=7)
    return res
