"""Bit-compare every CUDA kernel of ``rec_pangu_tpu_torch`` between two trees.

Each tree runs every kernel wrapper (K1 lookup, K2 table gradient with ids
past both ends of the table at D = 32, 1 and 8, K7 at ContraRec's
device-view shape, K3 fused Adam on K2's ids at D = 32 with the dense
stream, D = 1 and D = 40, and at SASRec's shape with the dense stream and
bfloat16 moments, K4f inference and training forward, K4b, K6f, K6b, K5f,
K5b; K4f's saved activations too, and K4f at SASRec's shape) on the same
seeded inputs, in a process of its own that builds that tree's kernels.
The script prints one JSON line, each output array mapped to whether the
two trees gave the same bits, and exits 1 if any differs.
It checks a change that claims to leave the kernels' results alone, such
as a refactor of shared CUDA code.  Needs one CUDA card.

    mkdir -p _archive/parent && git archive HEAD | tar -x -C _archive/parent
    python3 scripts/torch_kernel_bits.py _archive/parent [--changed=PREFIX ...] [--rel-tol=T]

The second tree is this checkout unless a second path is given.  A change
that reorders one kernel's sums names its outputs with ``--changed`` (e.g.
``--changed=k4b_``): those may differ, each by at most ``--rel-tol``
(default 1e-5) of the array's largest entry, and their largest relative
difference is reported.  Temporary result files go to ``chiprun_out/`` and
are removed.
"""
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from rec_pangu_tpu_torch.ops.kernels import embedding_grad as k2, embedding_lookup as k1
from rec_pangu_tpu_torch.ops.kernels import fused_adam as k3, fused_encoder as k4
from rec_pangu_tpu_torch.ops.kernels import global_attn as k6, multimax_ce as k5
from rec_pangu_tpu_torch.ops.sequence_enc import TransformerEncoder

g = torch.Generator(device="cuda").manual_seed(5)
dev = "cuda"
out = {}
# K1 and K2: 8192 rows of 4 fields over a [4 x 100,000, 32] table
table = torch.randn(400_000, 32, generator=g, device=dev)
sparse = torch.randint(0, 100_000, (8192, 4), generator=g, device=dev, dtype=torch.int32)
offsets = torch.arange(4, device=dev, dtype=torch.int32) * 100_000
out["k1"] = k1.fused_embedding_lookup(table, sparse, offsets)
ids = k1.fused_ids(sparse, offsets).reshape(-1)
# ids past both ends of the table, some far past: they add nothing
ids[:8] = torch.tensor([-2 ** 31, 2 ** 31 - 1, -1, -7, 400_000, 400_003, -2 ** 20, 2 ** 30],
                       dtype=torch.int32, device=dev)
rows = torch.randn(ids.numel(), 32, generator=g, device=dev)
out["k2"] = k2.table_grad(ids, rows, table.shape[0])
# K2 at rows narrower than a warp (the levels' lanes over entries)
for dim in (1, 8):
    out[f"k2_d{dim}"] = k2.table_grad(
        ids, torch.randn(ids.numel(), dim, generator=g, device=dev), table.shape[0])
# K7 at ContraRec's device-view shape: 3 x 1024 histories of 50 over the
# [1,007,616, 64] table, padding 0 and a masked view's long run of one token
hist = torch.randint(1, 1_000_000, (3 * 1024 * 50,), generator=g, device=dev, dtype=torch.int32)
hist[torch.rand(hist.shape, generator=g, device=dev) < 0.1] = 0
hist[torch.rand(hist.shape, generator=g, device=dev) < 0.165] = 999_999
out["k7"] = k2.sorted_segment_accumulate(
    hist, torch.randn(hist.numel(), 64, generator=g, device=dev), 1_007_616)
# K3 with the dense stream
mu = torch.randn(table.shape, generator=g, device=dev) * 1e-4
nu = torch.rand(table.shape, generator=g, device=dev) * 1e-8
dense = torch.randn(table.shape, generator=g, device=dev) * 1e-3
k3.planned_adam_update(ids, rows, table, mu, nu, k3.adam_hyper(3, 1e-3), dense)
out.update(k3_p=table, k3_m=mu, k3_v=nu)
# K3 at the LR tables' D = 1 and the multi-task zoo's D = 40, on the same ids
for dim in (1, 40):
    t = torch.randn(400_000, dim, generator=g, device=dev) * 0.25
    mu = torch.randn(t.shape, generator=g, device=dev) * 1e-4
    nu = torch.rand(t.shape, generator=g, device=dev) * 1e-8
    r = torch.randn(ids.numel(), dim, generator=g, device=dev) * 1e-3
    k3.planned_adam_update(ids, r, t, mu, nu, k3.adam_hyper(3, 1e-3))
    out.update({f"k3_d{dim}_p": t, f"k3_d{dim}_m": mu, f"k3_d{dim}_v": nu})
# K3 at SASRec's shape: 1024 histories of 50 over [1,007,616, 64], a run of
# one item, the dense stream, bfloat16 moments
hist_ids = torch.randint(0, 1_000_000, (51_200,), generator=g, device=dev, dtype=torch.int32)
hist_ids[:3000] = 77
t = torch.randn(1_007_616, 64, generator=g, device=dev) * 0.25
mu = (torch.randn(t.shape, generator=g, device=dev) * 1e-4).bfloat16()
nu = (torch.rand(t.shape, generator=g, device=dev) * 1e-8).bfloat16()
k3.planned_adam_update(hist_ids, torch.randn(51_200, 64, generator=g, device=dev) * 1e-3, t, mu,
                       nu, k3.adam_hyper(2, 1e-3), torch.randn(t.shape, generator=g, device=dev)
                       * 1e-6)
out.update(k3_seq_bf16_p=t, k3_seq_bf16_m=mu, k3_seq_bf16_v=nu)
del t, mu, nu
# K4f and K4b at IOCRec's local encoder: 3 blocks of 2 heads, inner 128
for act, rate in (("gelu", 0.0), ("relu", 0.5)):
    enc = TransformerEncoder(64, 3, 2, 128, 0.0, 0.0, act, 1e-12,
                             torch.Generator().manual_seed(3)).to(dev)
    packed = [t.detach() for t in enc.packed()]
    x = torch.randn(1024, 50, 64, generator=g, device=dev) * 0.18
    kv = (torch.rand(1024, 50, generator=g, device=dev) < 0.9).float()
    with torch.no_grad():
        out[f"k4f_{act}"] = k4.fused_encoder(x, kv, packed, 2, True, act, 1e-12)
    xs = x.clone().requires_grad_()
    ps = [p.clone().requires_grad_() for p in packed]
    y = k4.fused_encoder(xs, kv, ps, 2, True, act, 1e-12, True, rate, rate, 7)
    grads = torch.autograd.grad(y, [xs] + ps, torch.randn(y.shape, generator=g, device=dev))
    out[f"k4f_train_{act}"] = y.detach()
    out.update({f"k4b_{act}_{i}": t for i, t in enumerate(grads)})
    out[f"k4f_saved_{act}"] = k4.launch_train(x, kv, packed, 2, True, act, 1e-12, rate, rate, 7,
                                              save=True)[1]
# K4f at SASRec's shape: 2 blocks of 4 heads, inner 32, prefix histories
enc = TransformerEncoder(64, 2, 4, 32, 0.0, 0.0, "gelu", 1e-3,
                         torch.Generator().manual_seed(4)).to(dev)
packed = [t.detach() for t in enc.packed()]
x = torch.randn(1024, 50, 64, generator=g, device=dev) * 0.18
lens = torch.randint(0, 51, (1024,), generator=g, device=dev)
kv = (torch.arange(50, device=dev)[None] < lens[:, None]).float()
with torch.no_grad():
    out["k4f_sasrec"] = k4.fused_encoder(x, kv, packed, 4, True, "gelu", 1e-3)
out["k4f_train_sasrec"], out["k4f_saved_sasrec"] = k4.launch_train(
    x, kv, packed, 4, True, "gelu", 1e-3, 0.1, 0.1, 7, save=True)
# K6f and K6b at 3072 views with dropout 0.5
params = [torch.randn(64, 64, generator=g, device=dev) * 0.18,
          torch.randn(64, generator=g, device=dev) * 0.1,
          torch.randn(64, 64, generator=g, device=dev) * 0.18,
          torch.randn(64, generator=g, device=dev) * 0.1,
          torch.randn(50, 64, generator=g, device=dev) * 0.18]
xs = (torch.randn(3072, 50, 64, generator=g, device=dev) * 0.18).requires_grad_()
ps = [p.clone().requires_grad_() for p in params]
y = k6.global_attn(xs, ps, 7, 0.5, True)
grads = torch.autograd.grad(y, [xs] + ps, torch.randn(y.shape, generator=g, device=dev))
out["k6f"] = y.detach()
out.update({f"k6b_{i}": t for i, t in enumerate(grads)})
# K5f and K5b: 1024 users x 4 interests against 100,000 of 100,352 rows
u = torch.randn(1024, 4, 64, generator=g, device=dev) * 0.5
items = torch.randn(100_352, 64, generator=g, device=dev) * 0.18
lse = k5.multimax_lse(u, items, 100_000, True)
out["k5f"] = lse
out["k5b_du"], out["k5b_items"] = k5.multimax_grads(u, items, lse, 100_000, True)
torch.save({k: v.detach().cpu() for k, v in out.items()}, sys.argv[2])
'''


def run(tree: str, path: str) -> dict:
    subprocess.run([sys.executable, "-c", RUN, os.path.abspath(tree), path], check=True)
    try:
        return torch.load(path)
    finally:
        os.remove(path)


def main(argv) -> int:
    options = [a for a in argv[1:] if a.startswith("--")]
    paths = [a for a in argv[1:] if not a.startswith("--")]
    changed = tuple(a.split("=", 1)[1] for a in options if a.startswith("--changed="))
    rel_tol = float(next((a.split("=", 1)[1] for a in options if a.startswith("--rel-tol=")),
                         1e-5))
    if len(paths) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_bits: CUDA is not available", file=sys.stderr)
        return 1
    trees = (paths[0], paths[1] if len(paths) == 2 else ROOT)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    first, second = (run(t, os.path.join(out_dir, f"bits_{i}.pt")) for i, t in enumerate(trees))
    same = {k: bool(torch.equal(first[k], second[k])) for k in first}
    rel = {k: ((second[k] - first[k]).abs().max() / first[k].abs().max().clamp(min=1e-30)).item()
           for k in first if k.startswith(changed) and changed}
    ok = all(v or k.startswith(changed) and changed for k, v in same.items())
    ok = ok and all(v <= rel_tol for v in rel.values())
    print(json.dumps({"trees": trees, "bit_equal": same, "changed_max_rel_diff": rel,
                      "rel_tol": rel_tol}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
