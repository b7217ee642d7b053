"""Rank groups for graph parallelism over ``torch.distributed``: the
counterpart of ``gnnome_tpu/parallel/mesh.py``.

A ``Group`` is one rank's view of P processes that together hold one graph
(``parallel/halo.py``).  ``spawn(fn, P, ...)`` starts them on this host and
returns what each returned; ``run(fn, P, ...)`` does the same, or, in a
process that a launcher started (``torchrun`` / ``python -m
torch.distributed.run``, one launcher per host), joins the launcher's
group as its rank and returns this rank's result.  The transport:

* **NCCL** when the model runs on CUDA and the host has a GPU for each of
  its ranks: local rank l on ``cuda:l``, collectives on the card's
  tensors.
* **gloo** otherwise: CPU ranks, or several ranks sharing one card (NCCL
  refuses two ranks on one device).  gloo's point-to-point calls take CPU
  tensors only, so with CUDA tensors every message is staged through pinned
  host buffers here, explicitly; the model's tensors stay on the card.

Rendezvous: ``spawn``'s ranks meet at a ``torch.distributed.FileStore``
in a temporary directory (no socket, one host); a launcher's ranks at the
``TCPStore`` its environment names (``init_method="env://"``: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; the
global rank is the host index times the local ranks plus the local rank,
as ``torchrun`` sets it).  ``compute.mesh`` must equal ``WORLD_SIZE``
there.  Every collective times out after ``TIMEOUT_S``, so a rank that
hangs makes the others fail; ``spawn`` joins its ranks (with a deadline if
asked), and when a rank fails it kills the others and raises.  Where the
ranks may see different files (a launcher per host), rank 0 decides and
``Group.broadcast`` hands its decision to the others.

Sums over ranks are gathered and added in rank order, the same on every
rank, so replicated values (parameters, their gradients, statistics) stay
bitwise equal across ranks whatever the backend's reduction order.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import queue
import socket
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
    """``(backend, shared)`` for ``size`` ranks of one host computing on
    ``device`` (``compute.device``): NCCL with a GPU per rank where the
    host has enough GPUs, else gloo; ``shared``: the ranks share one
    card."""
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


@dataclass(frozen=True)
class Launch:
    """This process's place in a launcher's group (its environment)."""
    rank: int
    size: int
    local_rank: int
    local_size: int


LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT")


def launched() -> Launch | None:
    """This process's ``Launch`` when a launcher started it (``RANK`` and
    ``WORLD_SIZE`` set), else None.  Raises when the launcher's other
    variables are missing."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    missing = [k for k in LAUNCH_ENV if k not in env]
    if missing:
        raise RuntimeError(f"RANK and WORLD_SIZE are set but {missing} are "
                           "not: start the ranks with torchrun (python -m "
                           "torch.distributed.run)")
    size = int(env["WORLD_SIZE"])
    return Launch(int(env["RANK"]), size, int(env["LOCAL_RANK"]),
                  int(env.get("LOCAL_WORLD_SIZE", size)))


def check_launch(mesh: int) -> bool:
    """Whether this process is a rank of a launcher's group of more than
    one rank.  Raises when ``compute.mesh`` (0 or 1: one device) is not
    the group's ``WORLD_SIZE``: every rank of the group must run the same
    sharded step."""
    launch = launched()
    if launch is None:
        return False
    if max(mesh, 1) != launch.size:
        raise ValueError(
            f"compute.mesh={mesh} but the launcher started WORLD_SIZE="
            f"{launch.size} ranks; set --set compute.mesh={launch.size}, "
            "or run without the launcher")
    return launch.size > 1


def wants_group(mesh: int) -> bool:
    """Whether an entry point with ``compute.mesh`` runs over a group:
    ``mesh > 1``, or a launcher's group (``check_launch``, which refuses a
    ``mesh`` that is not its size)."""
    return check_launch(mesh) or mesh > 1


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
    local_rank: int = 0
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

    def broadcast(self, obj):
        """Rank 0's ``obj`` (any picklable value) on every rank: where the
        ranks may see different files (a launcher per host), rank 0
        decides.  Rank 0 sends its pickle's bytes (counted in ``sent``)."""
        data = pickle.dumps(obj) if self.rank == 0 else b""
        dev = self.device if self.backend == "nccl" else "cpu"
        n = torch.tensor([len(data)], dtype=torch.int64, device=dev)
        dist.broadcast(n, src=0)
        n = int(n.item())
        buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
               if self.rank == 0 else
               torch.empty(n, dtype=torch.uint8, device=dev))
        dist.broadcast(buf, src=0)
        self.calls["collective"] += 1
        if self.rank == 0:
            self.sent["collective"] += n
            return obj
        return pickle.loads(buf.cpu().numpy().tobytes())


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
def _rank_device(device: str, backend: str, local_rank: int) -> torch.device:
    """The device a rank's model runs on: ``cuda:{local_rank}`` under NCCL,
    the named (or first) card when the ranks share one, else the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from ..config import resolve_device
        dev = resolve_device(f"cuda:{local_rank}" if backend == "nccl"
                             else (device if dev.index is not None
                                   else "cuda:0"))
        torch.cuda.set_device(dev)
    return dev


def _rank_main(rank, size, store_path, device, results, fn, args):
    """One rank: join the group, run ``fn(group, *args)``, report.  Ranks
    other than 0 print nothing (their errors still reach the caller)."""
    torch.set_num_threads(1)
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        backend, shared = transport(device, size)
        dev = _rank_device(device, backend, rank)
        store = dist.FileStore(store_path, size)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=size,
                                timeout=timedelta(seconds=TIMEOUT_S), **kw)
        group = Group(rank, size, dev, backend, staged=shared,
                      local_rank=rank)
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


def join(device: str = "cpu") -> Group:
    """Join the group of the launcher that started this process (see
    ``launched``; the counterpart of ``jax.distributed.initialize()``)
    through the ``TCPStore`` its environment names, and return this rank's
    ``Group``.  The transport: NCCL where this host has a GPU for each of
    its ranks (``LOCAL_WORLD_SIZE``; local rank l on ``cuda:l``) and no two
    ranks of the group hold the same card (they publish its UUID in the
    store; launchers for two "hosts" on one machine share its cards), else
    gloo with the messages staged through host memory.  One thread a rank,
    as ``spawn``'s.  With CUDA, local rank 0 builds the kernel library
    while the others wait.  ``leave`` ends the group."""
    launch = launched()
    if launch is None:
        raise RuntimeError("join: no launcher started this process (RANK, "
                           "WORLD_SIZE unset); use spawn")
    backend, shared = transport(device, launch.local_size)
    torch.set_num_threads(1)
    dev = _rank_device(device, backend, launch.local_rank)
    timeout = timedelta(seconds=TIMEOUT_S)
    store, _, _ = next(dist.rendezvous("env://", launch.rank, launch.size,
                                       timeout=timeout))
    if dev.type == "cuda":
        store.set(f"gnnome_card/{launch.rank}", _card_id(dev))
        cards = {store.get(f"gnnome_card/{r}") for r in range(launch.size)}
        if backend == "nccl" and len(cards) < launch.size:
            backend, shared = "gloo", True
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=launch.rank,
                            world_size=launch.size, timeout=timeout, **kw)
    if dev.type == "cuda":
        if launch.local_rank == 0:
            from ..ops.kernels import build_kernels
            build_kernels()
        dist.barrier()
    return Group(launch.rank, launch.size, dev, backend, staged=shared,
                 local_rank=launch.local_rank)


def _card_id(dev: torch.device) -> bytes:
    """The card's UUID (its host name and index where torch gives none)."""
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    name = (str(uuid) if uuid is not None
            else f"{socket.gethostname()}/{dev.index}")
    return name.encode()


def leave() -> None:
    """End this process's group (``join``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def run(fn, size: int, *args, device: str = "cpu"):
    """``fn(group, *args)`` over ``size`` ranks.  In a process a launcher
    started (``check_launch``: ``size`` must be its ``WORLD_SIZE``) it
    joins the launcher's group and returns this rank's result (ranks
    other than 0 print nothing meanwhile); otherwise it starts the ranks
    on this host (``spawn``) and returns rank 0's."""
    if not check_launch(size):
        return spawn(fn, size, *args, device=device)[0]
    group = join(device)
    try:
        with contextlib.ExitStack() as quiet:
            if group.rank:
                quiet.enter_context(contextlib.redirect_stdout(
                    quiet.enter_context(open(os.devnull, "w"))))
            print(f"halo: {size} ranks from launchers, {group.backend}"
                  + (", strips staged through host" if group.staged else ""),
                  flush=True)
            return fn(group, *args)
    finally:
        leave()
