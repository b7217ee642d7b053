"""The card's stream ceiling: the port's counterpart of
``scripts/dma_probe.py``, the TPU probe of per-block DMA cost.

    python -m gnnome_tpu_torch.probes.dma_probe [--reps R] [--width D]
        [--dtype bfloat16|float32] [--et-divisor N] [--device cuda|cpu]
        [--seed S]

``stream_sum(xs, T, ET)`` (``csrc/probes/stream_sum.cu``) writes ``out =
xs[0] + xs[1] + ... + xs[K-1]`` over rows ``[T * ET, d]`` in T logical
blocks of ET rows each, the JAX kernel's ``BlockSpec((ET, d), lambda t: (t,
0))`` on a ``(T,)`` grid, adding left to right (in bf16 each add rounded to
bf16).  On the card each block is cut into tiles of 1,024 16-byte words,
one CTA a tile and one word of every input a thread, launched in address
order, so a small T fills the card as a large one does.  As in the JAX
probe, ``reps`` calls are chained, the output fed back as input 0 (the
JAX ``fori_loop``), over the K sweep (K = 1, 2, 4, 8, 12 at T = 768, ET =
2048) and the grid sweep at constant bytes (K = 4, (T, ET) from (192,
8192) to (3072, 512)).  Each line is one
JSON object: T, ET, K, ms per call (CUDA events around the chain queued
behind a sleep kernel, the device's time alone, median of 5), GB/s of the
(K + 1) blocks moved, microseconds per block and per block input, the
bound at the card's nominal 3.35 TB/s and, at K = 1 and 2, the one
PyTorch call that computes the same function (``copy_``, ``torch.add``)
timed the same way.  ``--et-divisor`` divides every ET (a smaller run);
with ``--device cpu`` the plain version runs and times are host-clock
``cpu_ms``.  Inputs are drawn from ``--seed`` (the JAX probe's are ones).
"""
from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..ops import kernels as K
from . import bound, device_label, library, raise_on, time_ms, timed

MAX_INPUTS = 12
K_SWEEP = ((768, 2048, 1), (768, 2048, 2), (768, 2048, 4), (768, 2048, 8),
           (768, 2048, 12))
GRID_SWEEP = ((192, 8192, 4), (384, 4096, 4), (768, 2048, 4),
              (1536, 1024, 4), (3072, 512, 4))


def stream_sum_plain(xs):
    """``xs[0] + xs[1] + ... + xs[K-1]``, added left to right (in bf16 each
    add rounds to bf16); a copy of ``xs[0]`` for K = 1."""
    acc = xs[0].clone()
    for x in xs[1:]:
        acc = acc + x
    return acc


def _check_inputs(xs, T: int, ET: int):
    if not 1 <= len(xs) <= MAX_INPUTS:
        raise ValueError(f"stream_sum: {len(xs)} inputs, expected 1 to "
                         f"{MAX_INPUTS}")
    x0 = xs[0]
    if x0.dim() != 2 or x0.shape[0] != T * ET:
        raise ValueError(f"stream_sum: input shape {tuple(x0.shape)}, "
                         f"expected [T * ET = {T * ET}, d]")
    dt = K._edge_dtype("stream_sum", x0)
    for i, x in enumerate(xs):
        K._check(f"xs[{i}]", x, dt, x0.shape, x0.device)
    return dt


def stream_sum(xs, T: int, ET: int):
    """The streaming sum of ``xs`` (K <= 12 tensors [T * ET, d] of one
    dtype, float32 or bfloat16) in T logical blocks of ET rows: returns
    what ``stream_sum_plain`` returns, bit for bit.  On the card each
    block's ET * d elements must be whole 16-byte words, and every tensor
    16-byte aligned; the kernel masks the last tile of each block."""
    dt = _check_inputs(xs, T, ET)
    if xs[0].device.type == "cpu":
        return stream_sum_plain(xs)
    if xs[0].device.type != "cuda":
        raise ValueError(f"stream_sum: unsupported device {xs[0].device}")
    dev = xs[0].device
    block_bytes = ET * xs[0].shape[1] * xs[0].element_size()
    out = torch.empty_like(xs[0])
    if block_bytes % 16 or any(t.data_ptr() % 16 for t in (*xs, out)):
        raise ValueError("stream_sum: a block of ET rows must be whole "
                         "16-byte words and every tensor 16-byte aligned")
    if T == 0 or block_bytes == 0:
        return out
    ptrs = (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.gn_stream_sum(len(xs), ptrs, out.data_ptr(), T,
                               block_bytes // 16, int(dt == torch.bfloat16),
                               torch.cuda.current_stream(dev).cuda_stream)
    raise_on(rc, "stream_sum")
    stream_sum.launches += 1
    return out


stream_sum.launches = 0


def cost(K_: int, rows: int, d: int, es: int):
    """Bytes and float32 operations of one sum: K inputs read and one
    output written, ``es`` bytes an element; K - 1 adds per element."""
    return (K_ + 1) * rows * d * es, float((K_ - 1) * rows * d)


def chain(fn, xs, T: int, ET: int, reps: int):
    """``reps`` calls of ``fn`` (``stream_sum`` or a plain one), each
    output fed back as input 0."""
    a = xs[0]
    for _ in range(reps):
        a = fn([a, *xs[1:]], T, ET)
    return a


def inputs(K_: int, rows: int, d: int, dtype, device, seed: int = 0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(rows, d, device=device, generator=gen).to(dtype)
            for _ in range(K_)]


def library_call(xs):
    """The one PyTorch call that computes ``stream_sum`` for K = 1 (a copy)
    and K = 2 (an add), writing into a preallocated output; None for other
    K."""
    out = torch.empty_like(xs[0])
    if len(xs) == 1:
        return lambda: out.copy_(xs[0])
    if len(xs) == 2:
        return lambda: torch.add(xs[0], xs[1], out=out)
    return None


def run(T: int, ET: int, K_: int, d: int, dtype, reps: int, device,
        seed: int = 0) -> dict:
    """One line of the probe: ``reps`` chained calls at (T, ET, K)."""
    xs = inputs(K_, T * ET, d, dtype, device, seed)
    es = xs[0].element_size()
    ms = time_ms(lambda: chain(stream_sum, xs, T, ET, reps), device,
                 1) / reps
    nbytes, flops = cost(K_, T * ET, d, es)
    b_ms, b_by = bound(nbytes, flops)
    row = {"probe": "dma_probe", "T": T, "ET": ET, "K": K_, "d": d,
           "dtype": str(dtype).split(".")[1], "reps": reps,
           **device_label(device), "bytes": nbytes, "bound_ms": b_ms,
           "bound_by": b_by}
    lib = library_call(xs)
    rates = {"gb_per_s": nbytes / ms / 1e6,
             "us_per_block": ms / T * 1e3,
             "us_per_block_input": ms / T / (K_ + 1) * 1e3,
             "over_bound": ms / b_ms}
    if lib is not None:
        rates["library_ms"] = time_ms(lib, device, reps)
    return timed(row, device, ms, **rates)


def sweep(device, dtype, reps: int = 20, d: int = 64, et_divisor: int = 1,
          seed: int = 0) -> list:
    """The JAX probe's K and grid sweeps (the bench geometry once)."""
    rows, seen = [], set()
    for T, ET, K_ in K_SWEEP + GRID_SWEEP:
        if (T, ET, K_) in seen:
            continue
        seen.add((T, ET, K_))
        rows.append(run(T, ET // et_divisor, K_, d, dtype, reps, device,
                        seed))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--et-divisor", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device (--device cpu runs the plain version)")
    for row in sweep(dev, getattr(torch, args.dtype), args.reps, args.width,
                     args.et_divisor, args.seed):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
