#!/usr/bin/env python3
"""K3's time on the card (``gnnome_tpu_torch.ops.kernels.k3_edge_stage``)
on the golden graph at d = 64 and 128, float32 and bf16, flip=False,
measured as ``chip_smoke.py``'s kernels phase measures it (``cuda_ms``:
CUDA events around 10 calls queued behind a sleep kernel, median of 10).

    python3 scripts/torch_k3_time.py [--seed N]

It imports ``gnnome_tpu_torch`` from ``PYTHONPATH`` when that holds
another tree (an older commit unpacked with ``git archive`` into an
ignored directory), else from this repository, so two trees compare in
one call on one card: run it as parent, change, change, parent.  Prints
one JSON line: the package's path, the card (``nvidia-smi``) and ms per
configuration beside K3's bound.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)          # after PYTHONPATH: another tree's package wins


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    import gnnome_tpu_torch
    from chip_smoke import (BF2, F4, GOLDEN, bf16_affine, bn_rows, bound,
                            cuda_ms, k3_cost, nvidia_smi)
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.ops import DeviceGraph
    from gnnome_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        print("torch_k3_time: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = DeviceGraph.from_graph(AssemblyGraph.load(GOLDEN), dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    u, v, v_csr, u_csr = g.roles(False)
    out = {}
    for dtype, es in ((torch.float32, F4), (torch.bfloat16, BF2)):
        for d in (64, 128):
            proj = randn(g.n_nodes, 5 * d).to(dtype)
            pu, pv = proj[:, :2 * d], proj[:, 2 * d:4 * d]
            b3e, e_in = randn(g.n_edges, d).to(dtype), randn(
                g.n_edges, d).to(dtype)
            bn = (bf16_affine(d, randn, rand) if dtype == torch.bfloat16
                  else bn_rows(d, randn, rand))
            ms = cuda_ms(lambda: K.k3_edge_stage(u, v, v_csr, u_csr, pu, pv,
                                                 b3e, e_in, bn), queued=True)
            b_ms, _ = bound(*k3_cost(g.n_nodes, g.n_edges, d, es))
            out[f"{str(dtype).split('.')[1]} d={d}"] = {"ms": ms,
                                                        "bound_ms": b_ms}
    print(json.dumps({"package": os.path.dirname(gnnome_tpu_torch.__file__),
                      "nvidia_smi": nvidia_smi(), "k3": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
