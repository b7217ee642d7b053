"""Wire traffic of the halo path, counted from the plan, and a serial time
model of it over P GPUs: the counterpart of
``gnnome_tpu/parallel/projection.py``, re-derived from this package's own
schedule (``parallel/halo.py``).  It is a model, not a measurement.

**What a rank sends** (``forward_traffic``, ``step_traffic``), exactly, from
the plan's K (strip rows) and R (overflow rows), the width d, the depth L
and the parameter count.  Every row crosses the wire in float32:
``_extend`` and ``_return`` widen bf16 rows first.

* ``halo_extend`` at width w: the strips, K rows of w to each neighbour
  (one ``p2p`` exchange); with R > 0, the overflow rows' sum over ranks,
  an all-gather of R x w summed in rank order (one ``collective``).
  ``halo_return`` moves the same at its width.
* An eval forward: per layer an extend at d and a return at 2d (the
  src-side sums), then an extend at d for the predictor; ``halo_score``
  then gathers the [E_r] float32 logits on rank 0 (one collective of the
  largest rank's edge count).
* A train step: each directional pass (two with the symmetry loss) moves
  the forward's exchanges forward and again backward (an extend's adjoint
  is a return at its width, and back), and per layer six statistics sums:
  K7's and K8's float64 ``[2d]`` and the node BatchNorm's two float32
  ``[d]`` sums, forward and backward; then the gradients' sum (every
  parameter, float32) and the loss's (one float32).

The counts are what ``Group.sent`` and ``Group.calls`` record
(tests/test_torch_projection.py holds them against gloo ranks).  ``wire``
is what a rank's links carry each way: its strips, and for a ring
all-gather (P - 1) times the payload, which each rank receives (and
forwards); the gather of the logits brings (P - 1) payloads to rank 0.

**The time model** (``project``) is serial, because the port exchanges at
a layer's head and waits (``parallel/halo.py`` ``halo_layer``):

    t_P = t_1 / P + wire / link rate + calls x latency

for the busiest rank, with t_1 the single-device time measured on the same
graph.  The JAX package's overlap windows (transfers hidden under measured
TPU op times) do not carry over; an overlapped schedule, sends at a
layer's tail, is ROADMAP Queue 1 item 6.  Link rates are data-sheet
figures (``LINKS``); the latency per call is the caller's, measured or
given, and has no default here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Data-sheet link rates, bytes/s each way per GPU:
# * NVLink 4 on the H100 SXM5: 900 GB/s per GPU, both directions together
#   (NVIDIA H100 Tensor Core GPU data sheet), so 450 GB/s each way;
# * NDR InfiniBand: 400 Gb/s per port, so 50 GB/s each way per HCA, one
#   HCA per GPU as in the DGX H100 (NVIDIA DGX H100 documentation: eight
#   ConnectX-7 400 Gb/s ports for the eight GPUs).
LINKS = {"nvlink4": 450e9, "ndr_ib": 50e9}
# bytes of a row element on the wire: float32 and bf16 rows travel as
# float32 (``ops.kernels.wide``)
ITEMSIZE = 4


@dataclass(frozen=True)
class Traffic:
    """One rank's traffic in one forward or step: ``sent`` bytes and
    ``calls`` by kind (``p2p``: ring exchanges; ``collective``: gathers
    and sums), as ``parallel.group.Group`` counts them, and ``wire``, the
    bytes through its links each way."""
    sent: dict
    calls: dict
    wire: int


def _add(a: Traffic, b: Traffic) -> Traffic:
    return Traffic({k: a.sent[k] + b.sent[k] for k in a.sent},
                   {k: a.calls[k] + b.calls[k] for k in a.calls},
                   a.wire + b.wire)


def _collectives(P: int, payloads) -> Traffic:
    """Sums over ranks (``Group.all_reduce``: an all-gather) of these
    payload sizes in bytes."""
    payloads = list(payloads)
    return Traffic({"p2p": 0, "collective": sum(payloads)},
                   {"p2p": 0, "collective": len(payloads)},
                   (P - 1) * sum(payloads))


def exchange_traffic(plan, rank: int, widths) -> Traffic:
    """``halo_extend`` / ``halo_return`` calls at these row widths on rank
    ``rank``: its strips (K rows to each neighbour) and, with R > 0, the
    overflow rows' sum."""
    kl, kr = plan.strips(rank)
    strips = [(kl + kr) * w * ITEMSIZE for w in widths]
    p2p = Traffic({"p2p": sum(strips), "collective": 0},
                  {"p2p": len(strips) if kl + kr else 0, "collective": 0},
                  sum(strips))
    if not plan.R:
        return p2p
    return _add(p2p, _collectives(plan.n_parts,
                                  [plan.R * w * ITEMSIZE for w in widths]))


def _gather_logits(plan, rank: int) -> Traffic:
    """``gather_edges``: every rank's [E_r] float32 logits, padded to the
    largest rank's count, to rank 0."""
    rows = int(np.diff(plan.cuts).max())
    nbytes = rows * 4
    P = plan.n_parts
    return Traffic({"p2p": 0, "collective": nbytes},
                   {"p2p": 0, "collective": 1},
                   (P - 1) * nbytes if rank == 0 else nbytes)


def forward_traffic(plan, rank: int, d: int, num_layers: int) -> Traffic:
    """Rank ``rank``'s traffic in one eval forward (``halo_forward``) of
    the batch-norm SymGatedGCN at width ``d`` and the gather of its logits
    on rank 0: what ``halo_score`` moves."""
    t = exchange_traffic(plan, rank, [d, 2 * d] * num_layers + [d])
    return _add(t, _gather_logits(plan, rank))


def step_traffic(plan, rank: int, d: int, num_layers: int, n_params: int,
                 passes: int = 2) -> Traffic:
    """Rank ``rank``'s traffic in one halo train step
    (``halo_train_step``): ``passes`` directional passes (2 with the
    symmetry loss), each forward and backward, the gradients' and the
    loss's sums."""
    widths = ([d, 2 * d] * num_layers + [d]) * 2 * passes
    t = exchange_traffic(plan, rank, widths)
    stats = [2 * d * 8, d * 4, d * 4] * 2 * num_layers * passes
    return _add(t, _collectives(plan.n_parts, stats + [n_params * 4, 4]))


@dataclass(frozen=True)
class Point:
    """The model at P ranks: the plan's K, R and route; seconds of the
    busiest rank's compute (t_1 / P), wire and latency; their sum; the
    efficiency t_1 / (P t_P); that rank's wire bytes and calls."""
    P: int
    K: int
    R: int
    route: str
    t_compute_s: float
    t_wire_s: float
    t_latency_s: float
    t_step_s: float
    efficiency: float
    wire_bytes: int
    calls: dict

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def project(t1_s: float, plan, traffic: list, link_bytes_per_s: float,
            latency_s: dict) -> Point:
    """The serial model at ``plan.n_parts`` ranks from the single-device
    time ``t1_s`` and every rank's ``Traffic``: the slowest rank's
    ``t1_s / P + wire / link_bytes_per_s + sum of calls x latency_s[kind]``
    (``latency_s``: seconds per call, by kind ``p2p`` and
    ``collective``)."""
    P = plan.n_parts

    def comm(t: Traffic) -> tuple[float, float]:
        return (t.wire / link_bytes_per_s,
                sum(n * latency_s[k] for k, n in t.calls.items()))

    busiest = max(traffic, key=lambda t: sum(comm(t)))
    t_wire, t_lat = comm(busiest)
    t_step = t1_s / P + t_wire + t_lat
    return Point(P, plan.K, plan.R, plan.route, t1_s / P, t_wire, t_lat,
                 t_step, t1_s / (P * t_step), busiest.wire,
                 dict(busiest.calls))


def project_curve(src, dst, n_nodes: int, t1_s: float, counts, mode: str,
                  d: int, num_layers: int, n_params: int,
                  link_bytes_per_s: float, latency_s: dict,
                  passes: int = 2) -> tuple[list, list]:
    """``(points, skipped)``: the model at each rank count of ``counts``
    on graph ``(src, dst)`` for ``mode`` ``eval`` (a forward and the
    logits' gather) or ``train`` (a step), from the real plan
    (``parallel.halo.plan_graph``) at each count; a count whose plan
    cannot be built is skipped, with the reason."""
    from .halo import plan_graph

    points, skipped = [], []
    for P in counts:
        try:
            plan, _ = plan_graph(src, dst, n_nodes, P)
        except ValueError as e:
            skipped.append({"P": P, "reason": str(e)})
            continue
        if mode == "eval":
            traffic = [forward_traffic(plan, r, d, num_layers)
                       for r in range(P)]
        else:
            traffic = [step_traffic(plan, r, d, num_layers, n_params, passes)
                       for r in range(P)]
        points.append(project(t1_s, plan, traffic, link_bytes_per_s,
                              latency_s))
    return points, skipped
