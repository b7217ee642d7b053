#!/usr/bin/env python3
"""Run one cell of the benchmark of ``gnnome_tpu_torch`` once, on the card.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; everything it
names is found by name under ``benchmarks/`` (``harness/manifest.py``).
Set-up (from this process's start: the kernel library's load or build into
the checkout's ``build/``, the graphs, the device graphs, the weights and
the first steps or requests) is ``setup_s``; then the window runs for
``--seconds``; with ``--trace 1`` a fixed traced segment follows and the
line carries the cell's per-layer metrics instead of its end-to-end ones.
The check of ``correct`` runs last, against the plain reference.

The last line of standard output is the result object; the last lines of
standard error name each number compared, its value and its limit.  Exits
2, printing no result, without a CUDA device or with fewer than the cell's
chips, and 3 if JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _finite(x):
    """``x`` with every non-finite float as its name ("inf", "nan"), so the
    result line is strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    # a fixed cache inside the checkout, should anything compile with Triton
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    import torch

    from benchmarks.harness import manifest, runner

    cell = manifest.cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = runner.run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", T0)
    bad = runner.forbidden_modules()
    if bad:
        print(f"loaded JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
