"""Bit-compare every CUDA kernel of ``rec_pangu_tpu_torch`` between two trees.

Each tree runs every kernel wrapper (K1 lookup, K2 table gradient, K3 fused
Adam, K4f inference and training forward, K4b, K6f, K6b, K5f, K5b) on the
same seeded inputs, in a process of its own that builds that tree's kernels.
The script prints one JSON line, each output array mapped to whether the two
trees gave the same bits, and exits 1 if any differs.  It checks a change
that claims to leave the kernels' results alone, such as a refactor of shared
CUDA code.  Needs one CUDA card.

    mkdir -p _archive/parent && git archive HEAD | tar -x -C _archive/parent
    python3 scripts/torch_kernel_bits.py _archive/parent

The second tree is this checkout unless a second path is given.  Temporary
result files go to ``chiprun_out/`` and are removed.
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
rows = torch.randn(ids.numel(), 32, generator=g, device=dev)
out["k2"] = k2.table_grad(ids, rows, table.shape[0])
# K3 with the dense stream
mu = torch.randn(table.shape, generator=g, device=dev) * 1e-4
nu = torch.rand(table.shape, generator=g, device=dev) * 1e-8
dense = torch.randn(table.shape, generator=g, device=dev) * 1e-3
k3.planned_adam_update(ids, rows, table, mu, nu, k3.adam_hyper(3, 1e-3), dense)
out.update(k3_p=table, k3_m=mu, k3_v=nu)
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
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_bits: CUDA is not available", file=sys.stderr)
        return 1
    trees = (argv[1], argv[2] if len(argv) == 3 else ROOT)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    first, second = (run(t, os.path.join(out_dir, f"bits_{i}.pt")) for i, t in enumerate(trees))
    same = {k: bool(torch.equal(first[k], second[k])) for k in first}
    print(json.dumps({"trees": trees, "bit_equal": same}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
