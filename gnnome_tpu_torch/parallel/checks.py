"""Rank functions that run the halo path for a comparison with one device:
each takes the rank's ``Group`` first, so ``parallel.group.spawn`` can start
it, and returns numpy results (rank 0 the gathered ones) for the caller to
hold against its single-device run.  The tests use them; ``run_jobs``
runs several in one group.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, compute_dtype
from ..models.convert import load_model_pytrees, numpy_from_module_state
from ..models.zoo import get_model
from ..ops.kernels import launch_counts, reset_launch_counts
from .halo import (dropout_generator, gather_edges, halo_eval_step,
                   halo_example_from_unit, halo_extend, halo_forward,
                   halo_return, halo_score, halo_supported, halo_train_step,
                   shard_graph)
from .sharded import sharded_forward, sharded_score


def run_jobs(group, jobs) -> list:
    """``[fn(group, *args) for fn, args in jobs]``, in one group; a dict
    result gains ``job_s``, the seconds its job took on this rank."""
    out = []
    for fn, args in jobs:
        t0 = time.perf_counter()
        r = fn(group, *args)
        if isinstance(r, dict):
            r["job_s"] = time.perf_counter() - t0
        out.append(r)
    return out


def collective_job(group, width: int, reps: int) -> dict:
    """Milliseconds of one ``all_reduce`` and one ring ``exchange`` of a
    ``[width]`` / ``[1, width]`` float32 tensor on the rank's device, with
    the device otherwise idle, and of the ``all_reduce`` of a host tensor
    (no device copy; medians of ``reps``).  On gloo with a CUDA tensor,
    also whether gloo's own ``all_reduce`` takes it unstaged."""
    t = torch.ones(width, device=group.device)
    t_host = torch.ones(width)
    out = {"rank": group.rank, "width": width,
           "all_reduce": _timed(lambda: group.all_reduce(t), group.device,
                                reps),
           "exchange": _timed(lambda: group.exchange(t[None], t[None]),
                              group.device, reps),
           "all_reduce_host": _timed(lambda: group.all_reduce(t_host),
                                     torch.device("cpu"), reps)}
    if group.backend == "gloo" and t.is_cuda:
        probe = t.clone()
        try:
            dist.all_reduce(probe)
            _sync(group.device)
            out["gloo_all_reduce_cuda"] = (
                f"takes CUDA tensors (sum {float(probe[0])})")
        except (RuntimeError, ValueError) as e:
            out["gloo_all_reduce_cuda"] = f"refuses CUDA tensors: {e}"[:300]
    return out


def _copy(tree):
    """A numpy pytree detached from the tensors it may view."""
    return {k: _copy(v) if isinstance(v, dict) else np.array(v)
            for k, v in tree.items()}


def _model(params, state, cfg: Config, device):
    model = get_model(cfg.model)
    load_model_pytrees(model, params, state)
    return model.to(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, reps: int) -> dict:
    """Host-clock and CUDA-event milliseconds of ``reps`` calls of ``fn``
    (after one warm-up call), medians."""
    fn()
    host, dev = [], []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        fn()
        if device.type == "cuda":
            b.record()
        _sync(device)
        host.append((time.perf_counter() - t0) * 1e3)
        if device.type == "cuda":
            dev.append(a.elapsed_time(b))
    return {"host_ms": float(np.median(host)),
            "event_ms": float(np.median(dev)) if dev else None}


def exchange_job(group, plan, seed: int, width: int) -> dict:
    """``halo_extend`` and ``halo_return`` on random float64 data, forward
    and backward: this rank's block of a global ``[N, width]`` array drawn
    from ``seed``, extended; a random ``[n_ext, width]`` array (seed, rank)
    returned; and the gradients of ``<extend(h), y>`` and ``<return(y),
    h>``.  Returns the rank's arrays."""
    n = plan.n_nodes
    x_all = np.random.default_rng(seed).normal(size=(n, width))
    zeros = np.zeros((n, 1), np.float32)
    sh = shard_graph(plan, group.rank, zeros, zeros,
                     np.zeros((plan.n_edges, 1), np.float32), None,
                     group.device)
    lo, hi = plan.block(group.rank)
    y = np.random.default_rng([seed, group.rank]).normal(
        size=(plan.n_ext(group.rank), width))
    h = torch.tensor(x_all[lo:hi], device=group.device, requires_grad=True)
    yt = torch.tensor(y, device=group.device, requires_grad=True)
    ext = halo_extend(sh, group, h)
    (ext * yt.detach()).sum().backward()
    ret = halo_return(sh, group, yt)
    (ret * h.detach()).sum().backward()
    return {"rank": group.rank, "ext": ext.detach().cpu().numpy(),
            "ret": ret.detach().cpu().numpy(), "y": y,
            "d_h": h.grad.cpu().numpy(), "d_y": yt.grad.cpu().numpy()}


def score_job(group, src, dst, n_nodes: int, x, e, params, state,
              cfg: Config, reps: int = 0) -> dict:
    """The eval forward of the graph over the group, on the halo path for
    the batch-norm SymGatedGCN and on the sharded path for every other
    model (``cfg.model``): on rank 0 the host-order logits; on every rank
    its launches, the plan (route, K, R; ``proc`` the processor graph's
    where it has its own), its shard's sizes, the bytes it sent and the
    exchanges and collectives it joined in the forward, and with ``reps``
    its forward times."""
    model = _model(params, state, cfg, group.device)
    sent0, calls0 = dict(group.sent), dict(group.calls)
    reset_launch_counts()
    if halo_supported(cfg.model):
        logits, sh = halo_score(model, cfg, group, src, dst, n_nodes, x, e)
        proc = sh
        dt = compute_dtype(cfg)

        def forward():
            return halo_forward(model, sh, group, dt)
    else:
        logits, sg = sharded_score(model, cfg, group, src, dst, n_nodes, x,
                                   e)
        sh, proc = sg.sh, sg.proc

        def forward():
            return sharded_forward(model, sg, group)
    _sync(group.device)
    out = {"rank": group.rank, "launches": launch_counts(),
           "launches_bf16": launch_counts(torch.bfloat16),
           "n_ext": sh.plan.n_ext(group.rank), "n_edges": int(sh.g.n_edges),
           "bytes": {k: group.sent[k] - sent0[k] for k in sent0},
           "calls": {k: group.calls[k] - calls0[k] for k in calls0},
           "route": sh.plan.route, "K": sh.plan.K, "R": sh.plan.R,
           "proc": None if proc is sh else {
               "route": proc.plan.route, "K": proc.plan.K, "R": proc.plan.R,
               "n_ext": proc.plan.n_ext(group.rank),
               "n_edges": int(proc.g.n_edges)},
           "logits": logits}
    if reps:
        out["forward"] = _timed(forward, group.device, reps)
    return out


def train_step_job(group, unit, params, state, cfg: Config,
                   pos_weight: float, reps: int = 0) -> dict:
    """One halo train step from ``(params, state)`` on ``unit`` (a
    ``train.step.HostUnit``) with Adam at ``cfg.train.lr``: on every rank
    the loss, the parameters and state after the step (numpy pytrees), the
    launches, its shard's edge count and the bytes it sent and the
    exchanges and collectives it joined in the step; on rank 0 also the
    summed gradients and the host-order logits.  With ``reps`` also the
    step's time (further steps from the state reached)."""
    from ..train.step import make_optimizer

    model = _model(params, state, cfg, group.device)
    opt = make_optimizer(model, cfg.train.lr)
    gen = dropout_generator(cfg.train.seed, group.rank, group.device)
    sh = halo_example_from_unit(unit, group, group.device)
    reset_launch_counts()
    sent0, calls0 = dict(group.sent), dict(group.calls)
    loss, lo = halo_train_step(model, opt, sh, group, pos_weight, cfg, gen)
    _sync(group.device)
    sent = {k: group.sent[k] - sent0[k] for k in sent0}
    calls = {k: group.calls[k] - calls0[k] for k in calls0}
    counts, counts_bf16 = launch_counts(), launch_counts(torch.bfloat16)
    sd = model.state_dict()
    grads = {n: p.grad for n, p in model.named_parameters()}
    g_params, _ = numpy_from_module_state({**sd, **grads})
    new_params, new_state = map(_copy, numpy_from_module_state(sd))
    logits = gather_edges(sh, group, lo)
    out = {"rank": group.rank, "loss": float(loss), "params": new_params,
           "state": new_state, "launches": counts,
           "launches_bf16": counts_bf16, "route": sh.plan.route,
           "K": sh.plan.K, "R": sh.plan.R, "n_edges": int(sh.g.n_edges),
           "bytes": sent, "calls": calls,
           "grads": _copy(g_params) if group.rank == 0 else None,
           "logits": logits}
    if reps:
        out["step"] = _timed(
            lambda: halo_train_step(model, opt, sh, group, pos_weight, cfg,
                                    gen), group.device, reps)
    return out


def bench_unit(src, dst, n_nodes: int, seed: int = 0):
    """A training unit of a bare graph, as the JAX bench and multi-host
    smoke make one (bench.py:428-432, scripts/multihost_smoke.py:65-73):
    degrees, N(0, 1) edge features [E, 2] and Bernoulli(0.5) labels drawn
    from ``seed``."""
    from ..train.step import HostUnit

    rng = np.random.default_rng(seed)
    E = int(np.asarray(src).shape[0])
    e = rng.normal(size=(E, 2)).astype(np.float32)
    y = (rng.random(E) < 0.5).astype(np.float32)
    return HostUnit(np.bincount(dst, minlength=n_nodes).astype(np.float32),
                    np.bincount(src, minlength=n_nodes).astype(np.float32),
                    e, y, src, dst, n_nodes)


def multihost_inputs(n_nodes: int, size: int, device: str = "cpu"):
    """``(unit, params, state, cfg)`` of the multi-host smoke step
    (scripts/torch_multihost_smoke.py; the JAX package's
    scripts/multihost_smoke.py:55-79): ``random_bench_graph(n_nodes, 6.0,
    seed=0)`` as a ``bench_unit``, the default model from
    ``init_weights(1)``, masking off, ``compute.mesh`` ``size``."""
    from ..graphs.synthetic import random_bench_graph
    from ..models.convert import pytrees_from_model

    cfg = Config()
    cfg.compute.device = device
    cfg.compute.mesh = size
    cfg.train.masking = False
    src, dst = random_bench_graph(n_nodes, 6.0, seed=0)
    params, state = pytrees_from_model(get_model(cfg.model).init_weights(1))
    return bench_unit(src, dst, n_nodes), params, state, cfg


def per_rank_job(group, fn, args_of_rank):
    """``fn(*args_of_rank[group.rank], group=group)``: every rank with its
    own arguments (its own paths), as each host's launcher passes its own
    command line."""
    return fn(*args_of_rank[group.rank], group=group)


def eval_step_job(group, unit, params, state, cfg: Config,
                  pos_weight: float) -> dict:
    """The halo eval step's loss (every rank) and logits (rank 0)."""
    model = _model(params, state, cfg, group.device)
    sh = halo_example_from_unit(unit, group, group.device)
    loss, lo = halo_eval_step(model, sh, group, pos_weight, cfg)
    return {"rank": group.rank, "loss": float(loss),
            "logits": gather_edges(sh, group, lo)}


def failing_job(group, rank: int, hang_s: float) -> None:
    """Rank ``rank`` raises (``hang_s`` 0) or sleeps ``hang_s`` seconds;
    every rank then joins a sum over ranks, which the others wait in."""
    if group.rank == rank:
        if not hang_s:
            raise RuntimeError(f"rank {rank} fails on purpose")
        time.sleep(hang_s)
    group.all_reduce(torch.ones(1))
