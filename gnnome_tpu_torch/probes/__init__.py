"""Card probes: the port's counterparts of the JAX package's TPU probe
scripts, each a hand-written CUDA kernel beside its plain PyTorch version.

- ``probes.k3_ablate`` (``scripts/k3_ablate.py``): K3 with parts knocked
  out, and sweeps of its team size and ring depth, to split K3's time
  (``csrc/probes/k3_ablate.cu`` on ``csrc/k3_edge_stage.cuh``).
- ``probes.dma_probe`` (``scripts/dma_probe.py``): a streaming sum of K row
  blocks on a grid of T blocks, the card's stream ceiling
  (``csrc/probes/stream_sum.cu``).
- ``probes.mosaic_repro`` (``scripts/mosaic_f32_repro*.py``): every case of
  the five Mosaic repro scripts as a chain of four kernels, a row stack, a
  row gather, a segment sum and a small product
  (``csrc/probes/mosaic_ops.cu``).

Run them with ``python -m gnnome_tpu_torch.probes.k3_ablate``, ``python
-m gnnome_tpu_torch.probes.dma_probe`` and ``python -m
gnnome_tpu_torch.probes.mosaic_repro`` (``--device cpu`` runs the plain
versions).  Their kernels lie on no path of the system, so they are built
into a library of their own, ``build/libgnnome_probes.so``, at a probe's
first CUDA call (resource report ``build/nvcc_probes.log``).  As for the
kernels of ``ops/kernels.py``, a wrapper takes its plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises, and
counts its launches in ``<wrapper>.launches`` (``small_matmul`` also by
instantiation, in ``small_matmul.routes``).
"""
from __future__ import annotations

import ctypes
import os
import re
import statistics
import threading
import time

from ..ops import kernels as K

SOURCES = ("probes/k3_ablate.cu", "probes/stream_sum.cu",
           "probes/mosaic_ops.cu")
LIB_PATH = os.path.join(K.BUILD_DIR, "libgnnome_probes.so")

# H100 SXM data sheet: HBM3 bandwidth, the float32 (non-tensor-core) peak
# and the dense bf16 tensor-core peak, the rates behind every bound of
# PERF.md
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

_lock = threading.Lock()
_lib = None


def build_probes(force: bool = False) -> str:
    """Build ``build/libgnnome_probes.so`` if missing or stale."""
    return K.build_library(LIB_PATH, SOURCES, K.HEADERS, "nvcc_probes.log",
                           force)


def library():
    """The probe library, built and loaded at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_probes())
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.gn_k3_ablate.restype = I
            lib.gn_k3_ablate.argtypes = [
                I, I, I, I, I,               # part, team, stages, n_nodes, d
                P, P, P, P, P, P,            # v_ptr, v_perm, v_nbr, u_ptr, u_perm, u_nbr
                P, L, P, L,                  # proj_u, ldu, proj_v, ldv
                P, P, P,                     # b3e, e_in, bn
                P, P, P, I,                  # e_out, sum_v, sum_u, store_sums
                P, P, I, P]                  # walk_v, walk_u, bf16, stream
            lib.gn_stream_sum.restype = I
            lib.gn_stream_sum.argtypes = [
                I, P, P, I, L, I, P]         # k, inputs, out, n_blocks, words, bf16, stream
            lib.gn_row_stack.restype = I
            lib.gn_row_stack.argtypes = [
                I, I, I, I,                  # h, D, inverse, sigmoid
                P, L, P, L,                  # lo, ld_lo, hi, ld_hi
                P, L,                        # out, ld_out
                I, P]                        # bf16, stream
            lib.gn_row_gather.restype = I
            lib.gn_row_gather.argtypes = [
                I, I, I, P, P, L,            # n, rows, W, idx, table, ld_t
                P, I, P]                     # out, bf16, stream
            lib.gn_segment_sum.restype = I
            lib.gn_segment_sum.argtypes = [
                I, I, I, P, P, L,            # n, n_out, W, idx, pay, ld_p
                P, L, I, I, P]               # out, ld_o, dup, bf16, stream
            lib.gn_small_matmul.restype = I
            lib.gn_small_matmul.argtypes = [
                I, I, I, P, L, P, L,         # M, K, N, a, lda, b, ldb
                P, L, I, P]                  # out, ldo, bf16, stream
            lib.gn_small_matmul_smem.restype = I
            lib.gn_small_matmul_smem.argtypes = [I]      # bf16
            lib.gn_small_matmul_vector.restype = I
            lib.gn_small_matmul_vector.argtypes = [
                P, L, P, L, I]               # a, lda, b, ldb, bf16
            lib.gn_probes_error_string.restype = ctypes.c_char_p
            lib.gn_probes_error_string.argtypes = [I]
            _lib = lib
        return _lib


def raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = library().gn_probes_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def bound(nbytes: float, flops: float,
          flops_per_s: float = F32_FLOPS_PER_S):
    """Least time on the card in ms: the larger of bytes over the memory
    rate and the operations over their peak (float32 unless
    ``flops_per_s`` says otherwise); and which of the two."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / flops_per_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def time_ms(fn, device, calls: int, repeats: int = 5) -> float:
    """Milliseconds per call of ``fn``: on a CUDA device the median over
    ``repeats`` of CUDA events around ``calls`` calls that the host queues
    while the device still runs a sleep kernel, after warm-up (the device's
    time alone: the host's share of a call, which can exceed a short
    kernel's time, is left out); on the CPU the host clock around ``calls``
    calls, once."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) / calls * 1e3
    for _ in range(2):
        fn()
    torch.cuda.synchronize(device)
    times, cycles = [], 1 << 24            # ~10 ms of sleep at 1.7 GHz
    while len(times) < repeats:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        ahead = not a.query()              # the device still slept
        b.synchronize()
        if ahead:
            times.append(a.elapsed_time(b) / calls)
        else:                              # the host fell behind
            cycles *= 2
            if cycles > 1 << 32:
                raise RuntimeError("time_ms: the host cannot queue the "
                                   "calls behind a sleep kernel")
    return statistics.median(times)


def in_turns(kernel, library, device, calls: int) -> dict:
    """``kernel`` and ``library`` timed by ``time_ms`` in turns, kernel,
    library, library, kernel, so that a drift of the card's clock over the
    four reads falls on both alike: the two times of each, in that order."""
    k0, l0, l1, k1 = (time_ms(fn, device, calls)
                      for fn in (kernel, library, library, kernel))
    return {"kernel_ms": [k0, k1], "library_ms": [l0, l1]}


def ptxas_resources(log: str, names) -> list:
    """What ``nvcc -Xptxas -v`` reports for each entry function whose
    mangled name holds one of ``names``: the name, registers, stack frame,
    spill stores and loads and static shared memory (bytes), in the log's
    order."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = None
            if any(n in m.group(1) for n in names):
                cur = {"function": m.group(1), "registers": None,
                       "stack_bytes": 0, "spill_stores": 0,
                       "spill_loads": 0, "smem_bytes": 0}
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
            cur = None
    return out


def timed(row: dict, device, ms: float, **rates) -> dict:
    """``row`` with a time and its rates, named by where they were taken:
    ``ms`` and the rates on the card (CUDA events), ``cpu_ms`` and
    ``cpu_<rate>`` for a run of the plain versions on the CPU (host clock),
    never under the card's names."""
    pre = "" if device.type == "cuda" else "cpu_"
    return {**row, f"{pre}ms": ms, **{pre + k: v for k, v in rates.items()}}


def device_label(device) -> dict:
    """What ran: the card's name and the kernels, or the plain versions on
    the CPU."""
    import torch

    if device.type == "cuda":
        return {"device": torch.cuda.get_device_name(device),
                "kernel": "cuda"}
    return {"device": "cpu", "kernel": "plain"}


def launch_counts() -> dict:
    """Each probe wrapper's launches since the last reset, and
    ``small_matmul``'s by instantiation (``small_matmul:vector``,
    ``small_matmul:scalar``)."""
    from . import dma_probe, k3_ablate, mosaic_repro

    mm = mosaic_repro.small_matmul
    return {"k3_ablate": k3_ablate.k3_ablate.launches,
            "stream_sum": dma_probe.stream_sum.launches,
            **{name: fn.launches for name, fn in mosaic_repro.OPS.items()},
            **{f"small_matmul:{r}": n for r, n in mm.routes.items()}}


def reset_launch_counts() -> None:
    from . import dma_probe, k3_ablate, mosaic_repro

    k3_ablate.k3_ablate.launches = dma_probe.stream_sum.launches = 0
    for fn in mosaic_repro.OPS.values():
        fn.launches = 0
    mosaic_repro.small_matmul.routes = dict.fromkeys(
        mosaic_repro.MATMUL_ROUTES, 0)
