"""Rank groups for graph parallelism over ``torch.distributed``: the
counterpart of ``gnnome_tpu/parallel/mesh.py``.

A ``Group`` is one rank's view of P processes that together hold one graph
(``parallel/halo.py``).  ``spawn(fn, P, ...)`` starts them and returns what
each returned.  The transport:

* **NCCL** when the model runs on CUDA and the machine has at least P GPUs:
  rank r on ``cuda:r``, collectives on the card's tensors.
* **gloo** otherwise: CPU ranks, or several ranks sharing one card (NCCL
  refuses two ranks on one device).  gloo's point-to-point calls take CPU
  tensors only, so with CUDA tensors every message is staged through pinned
  host buffers here, explicitly; the model's tensors stay on the card.

Rendezvous is a ``torch.distributed.FileStore`` in a temporary directory
(no socket).  Every collective times out after ``TIMEOUT_S``, so a rank
that hangs makes the others fail; ``spawn`` joins its ranks (with a
deadline if asked), and when a rank fails it kills the others and raises.

Sums over ranks are gathered and added in rank order, the same on every
rank, so replicated values (parameters, their gradients, statistics) stay
bitwise equal across ranks whatever the backend's reduction order.
"""
from __future__ import annotations

import os
import queue
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT_S = 1800.0          # every collective's


def transport(device: str, size: int) -> tuple[str, bool]:
    """``(backend, shared)`` for ``size`` ranks computing on ``device``
    (``compute.device``): NCCL with a GPU per rank where there are enough
    GPUs, else gloo; ``shared``: the ranks share one card."""
    if torch.device(device).type != "cuda":
        return "gloo", False
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"compute.device={device!r} but no CUDA device is available; "
            "pass --set compute.device=cpu to run on the CPU")
    one_named = torch.device(device).index is not None
    if torch.cuda.device_count() >= size and not one_named:
        return "nccl", False
    return "gloo", True


def describe(device: str, size: int) -> str:
    """The run's first line: ranks, devices and transport."""
    backend, shared = transport(device, size)
    if torch.device(device).type != "cuda":
        return f"halo: {size} ranks on the CPU, gloo"
    if shared:
        return (f"halo: {size} ranks on 1 GPU, gloo, strips staged through "
                "host")
    return f"halo: {size} ranks on {size} GPUs, nccl"


@dataclass
class Group:
    """One rank of a group: its ``rank`` of ``size``, the ``device`` its
    model runs on and the transport (``backend``; ``staged``: CUDA tensors
    travel through host buffers).  ``sent`` counts the bytes this rank put
    on the wire and ``calls`` the exchanges and collectives it joined, by
    kind (``p2p``: ring exchanges; ``collective``: gathers and sums)."""
    rank: int
    size: int
    device: torch.device
    backend: str
    staged: bool
    sent: dict = field(default_factory=lambda: {"p2p": 0, "collective": 0})
    calls: dict = field(default_factory=lambda: {"p2p": 0, "collective": 0})
    _pinned: dict = field(default_factory=dict)

    # ---------------------------------------------------------- staging
    def _out(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """``t`` as the transport takes it: contiguous; for a staged CUDA
        tensor a copy in the pinned host buffer ``tag``; for NCCL on the
        card."""
        t = t.contiguous()
        if self.backend == "nccl":
            return t.to(self.device)
        if not (self.staged and t.is_cuda):
            return t
        buf = self._buffer(tag, t.shape, t.dtype)
        buf.copy_(t)
        return buf

    def _buffer(self, tag: str, shape, dtype) -> torch.Tensor:
        n = 1
        for s in shape:
            n *= int(s)
        pool = self._pinned.get((tag, dtype))
        if pool is None or pool.numel() < n:
            # a normal tensor even when first made under inference_mode:
            # the buffer outlives the call
            with torch.inference_mode(False):
                pool = self._pinned[(tag, dtype)] = torch.empty(
                    max(n, 1), dtype=dtype, pin_memory=True)
        return pool[:n].view(shape)

    def _empty(self, shape, dtype, tag: str) -> torch.Tensor:
        """A receive buffer: pinned host memory when staged, else on the
        transport's device."""
        if self.staged:
            return self._buffer(tag, shape, dtype)
        dev = self.device if self.backend == "nccl" else "cpu"
        return torch.empty(shape, dtype=dtype, device=dev)

    def _home(self, t: torch.Tensor) -> torch.Tensor:
        """A received tensor on the model's device (a copy: staging
        buffers are reused)."""
        return t.to(self.device, copy=True)

    # ------------------------------------------------------ collectives
    def exchange(self, to_left: torch.Tensor, to_right: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Send ``to_left`` to rank - 1 and ``to_right`` to rank + 1 (the
        ring's ends send nothing there) and return ``(from_left,
        from_right)``, what those neighbours sent this way: a message has
        the shape its sender's counterpart argument has, and an end of the
        ring receives an empty ``[0, width]``."""
        reqs, got = [], {}
        for side, peer, t in (("left", self.rank - 1, to_left),
                              ("right", self.rank + 1, to_right)):
            if not 0 <= peer < self.size:
                got[side] = to_left.new_zeros((0,) + tuple(t.shape[1:]))
                continue
            out = self._out(t, f"send_{side}")
            buf = self._empty(t.shape, t.dtype, f"recv_{side}")
            if out.numel():
                reqs.append(dist.isend(out, peer))
                reqs.append(dist.irecv(buf, peer))
                self.sent["p2p"] += out.numel() * out.element_size()
            got[side] = buf
        for r in reqs:
            r.wait()
        self.calls["p2p"] += bool(reqs)
        return (self._home(got["left"]), self._home(got["right"]))

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (each of the same shape), in rank order, on
        the model's device."""
        out = self._out(t, "gather")
        parts = [torch.empty_like(out) for _ in range(self.size)]
        dist.all_gather(parts, out)
        self.sent["collective"] += out.numel() * out.element_size()
        self.calls["collective"] += 1
        return [self._home(p) for p in parts]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, added in rank order: bitwise
        the same on every rank."""
        parts = self.all_gather(t)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return total

    def gather_rows(self, t: torch.Tensor, counts):
        """Rank r's ``t`` ([counts[r], ...]) on rank 0, as a list of host
        tensors in rank order (None on the other ranks)."""
        width = tuple(t.shape[1:])
        rows = max(counts)
        pad = t.new_zeros((rows,) + width)
        pad[: t.shape[0]] = t
        out = self._out(pad, "gather_rows")
        parts = ([self._empty(out.shape, out.dtype, f"rows_{r}")
                  for r in range(self.size)] if self.rank == 0 else None)
        dist.gather(out, parts, dst=0)
        self.sent["collective"] += out.numel() * out.element_size()
        self.calls["collective"] += 1
        if self.rank != 0:
            return None
        return [p[:c].to("cpu", copy=True) for p, c in zip(parts, counts)]


class AllReduce(torch.autograd.Function):
    """``group.all_reduce`` with its adjoint: every rank consumes the sum,
    so the gradient of each rank's input is the sum of the gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, d):
        return ctx.group.all_reduce(d), None


def all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Differentiable sum over the ranks (``AllReduce``)."""
    return AllReduce.apply(x, group)


# -------------------------------------------------------------- launching
def _rank_main(rank, size, store_path, device, results, fn, args):
    """One rank: join the group, run ``fn(group, *args)``, report.  Ranks
    other than 0 print nothing (their errors still reach the caller)."""
    torch.set_num_threads(1)
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        backend, shared = transport(device, size)
        dev = torch.device(device)
        if dev.type == "cuda":
            from ..config import resolve_device
            dev = resolve_device(f"cuda:{rank}" if backend == "nccl"
                                 else (device if dev.index is not None
                                       else "cuda:0"))
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, size)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=size,
                                timeout=timedelta(seconds=TIMEOUT_S), **kw)
        group = Group(rank, size, dev, backend, staged=shared)
        results.put((rank, True, fn(group, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, size: int, *args, device: str = "cpu",
          deadline_s: float | None = None) -> list:
    """Run ``fn(group, *args)`` on ``size`` ranks, each a process started
    with the ``spawn`` method (``fn`` and ``args`` are pickled: ``fn`` must
    be a module-level function of an importable module), and return the
    ranks' results in rank order.  ``device`` is ``compute.device``;
    ``deadline_s`` (default: none) bounds the whole call, ``TIMEOUT_S``
    every collective, so a rank that hangs makes the others fail.  Raises,
    after killing every rank still running, when a rank raises, dies or
    the deadline passes.  With CUDA the kernel library is built here
    first, once, not by every rank."""
    import torch.multiprocessing as mp

    if size < 2:
        raise ValueError(f"spawn: {size} ranks; a group has at least 2")
    if torch.device(device).type == "cuda":
        from ..ops.kernels import build_kernels
        transport(device, size)            # raises without a GPU
        build_kernels()
    print(describe(device, size), flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    end = None if deadline_s is None else time.monotonic() + deadline_s
    out, errors = [None] * size, []
    with tempfile.TemporaryDirectory(prefix="gnnome_group_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, size, os.path.join(tmp, "store"),
                                   device, results, fn, args), daemon=True)
                 for r in range(size)]
        for p in procs:
            p.start()
        try:
            done = 0
            while done < size and not errors:
                if end is not None and time.monotonic() > end:
                    errors.append(f"deadline of {deadline_s} s passed with "
                                  f"{size - done} rank(s) unfinished")
                    break
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"rank(s) {dead} died (exit codes "
                                      f"{[procs[r].exitcode for r in dead]})")
                    continue
                done += 1
                if ok:
                    out[rank] = value
                else:
                    errors.append(f"rank {rank} failed:\n{value}")
        finally:
            for p in procs:
                p.join(timeout=0 if errors else 30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("halo group failed: " + "\n".join(errors))
    return out
