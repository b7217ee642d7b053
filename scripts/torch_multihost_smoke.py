#!/usr/bin/env python
"""Multi-host smoke of gnnome_tpu_torch: one halo train step over ranks
that a launcher started on each host, the port's counterpart of
scripts/multihost_smoke.py (the JAX package's, through
``jax.distributed``).

Each host runs one launcher, which starts its local ranks; they join one
group through the ``TCPStore`` at the master address
(``parallel.group.join``):

    python -m torch.distributed.run --nnodes 2 --node-rank I \\
        --nproc-per-node L --master-addr HOST0 --master-port P \\
        scripts/torch_multihost_smoke.py [--device cpu] [--n-nodes N]

(``--node-rank`` 0 on HOST0, 1 on the other; on one machine both with
``--master-addr 127.0.0.1``).  Every rank builds the same graph and
training unit from the same seeds (``random_bench_graph(N, 6.0)``, the
JAX script's unit: ``parallel.checks.multihost_inputs``), runs one step
from ``init_weights(1)`` and prints

    MULTIHOST_OK rank=R world=W local=L transport=T loss=X launches={...}

``transport`` is ``nccl``, ``gloo`` or ``gloo+staged`` (ranks sharing a
card), ``loss`` the whole graph's, the same on every rank and bitwise that of
``parallel.group.spawn`` with W ranks on one host; ``launches`` this
rank's kernel launches in the step.  ``--device`` defaults to ``cuda``
(NCCL with a card of its own for every rank, else gloo ranks sharing
the card); it raises without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-nodes", type=int, default=16_384)
    args = ap.parse_args(argv)

    from gnnome_tpu_torch.parallel.checks import (multihost_inputs,
                                                  train_step_job)
    from gnnome_tpu_torch.parallel.group import join, launched, leave

    launch = launched()
    if launch is None:
        sys.exit("torch_multihost_smoke: start it with torch.distributed.run "
                 "(see the module docstring)")
    unit, params, state, cfg = multihost_inputs(args.n_nodes, launch.size,
                                                args.device)
    group = join(args.device)
    try:
        res = train_step_job(group, unit, params, state, cfg, 1.0)
        wire = group.backend + ("+staged" if group.staged else "")
        print(f"MULTIHOST_OK rank={group.rank} world={group.size} "
              f"local={group.local_rank} transport={wire} "
              f"loss={res['loss']!r} launches="
              f"{json.dumps(res['launches'], separators=(',', ':'))}",
              flush=True)
    finally:
        leave()


if __name__ == "__main__":
    main()
