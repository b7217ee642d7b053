"""K3's cost split on the card: the port's counterpart of
``scripts/k3_ablate.py``, the TPU probe that knocked parts out of K3's
windowed one-hot kernel to locate its cost.

    python -m gnnome_tpu_torch.probes.k3_ablate [--nodes N] [--reps R]
        [--variants NAME[:TEAM[:STAGES]],...] [--width D]
        [--dtype bfloat16|float32] [--device cuda|cpu] [--seed S]

The card's K3 (``csrc/k3_edge_stage.cu``) walks each node's CSR segment
with a team of lanes and a ``cp.async`` ring; it has no windows and no
one-hot products.  So the variants (``csrc/probes/k3_ablate.cu``, built
from ``csrc/k3_edge_stage.cuh``) knock out the card kernel's own parts,
each the counterpart of a JAX variant:

=============== ========================================= ===============
variant         what it leaves out                        JAX variant
=============== ========================================= ===============
full            nothing: K3, bit for bit                  full
edge_only       pass u and every node sum; pass v stores  no_scatter
                e_out only
sums_unstored   the node stores (the sums are still made) noout, dma_noout
fixed_rows      the random row gathers: B1h, A2h (pass v) static_in
                and A3h (pass u) come from the team's own
                node's row
stream_only     all arithmetic: the same walk and row     dma_only
                copies, ``e_out = ((b3e + e_in) + B1h[u])
                + B2h[v]``, no sums
walk_only       every row: the walk of slot numbers and   oh_only
                partners, one word per node and pass
=============== ========================================= ===============

``per_tile`` and ``full_reuse`` are layouts of the TPU's window partials;
the port has no window plans, and the probe refuses them (``REFUSED``).
The JAX chunk sweep becomes the team size (``TEAMS``) and ring depth
(2-4) of ``full``; ``--tile-e`` and ``--window`` have no counterpart.

Each line is one JSON object: the variant, team, stages, width and dtype,
the time per call (``ms``: CUDA events around ``--reps`` calls queued
behind a sleep kernel, the device's time alone, median of 5), M edges/s, the share of ``full``'s time at K3's own
team size and depth, and the variant's bound (``cost``).  With ``--device
cpu`` the plain versions run and the times are host-clock ``cpu_ms``.
The graph is ``random_bench_graph(--nodes, 6.0, seed=0)``, as in the JAX
probe; rows are drawn from ``--seed``.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import kernels as K
from . import bound, device_label, library, raise_on, time_ms, timed

VARIANTS = ("full", "edge_only", "sums_unstored", "fixed_rows",
            "stream_only", "walk_only")      # K3Part order
JAX_NAMES = {"full": ("full",), "edge_only": ("no_scatter",),
             "sums_unstored": ("noout", "dma_noout"),
             "fixed_rows": ("static_in",), "stream_only": ("dma_only",),
             "walk_only": ("oh_only",)}
REFUSED = {
    name: (f"{name} is a layout of the TPU kernel's window partials; the "
           "port has no window plans (its K3 walks CSR segments and writes "
           "each node's sums once), so it has no counterpart")
    for name in ("per_tile", "full_reuse")}
STAGES = 3                    # K3's ring depth (gn::kStages)
TEAMS = (8, 16, 32)
# the (variant, team, stages) csrc/probes/k3_ablate.cu instantiates
# (GN_PROBE_INSTANCES): every variant at K3's team sizes for d = 64 and
# 128, `full` also at T = 8 and at depths 2 and 4
INSTANCES = frozenset(
    [(v, t, STAGES) for v in VARIANTS for t in (16, 32)]
    + [("full", 8, STAGES)] + [("full", t, p) for t in (16, 32)
                               for p in (2, 4)])
_ALIASES = {j: v for v, names in JAX_NAMES.items() for j in names}
_NOT_BUILT, _NOT_VECTOR = -1, -2


def variant_name(name: str) -> str:
    """The card variant for ``name`` (a card variant or a JAX one)."""
    if name in REFUSED:
        raise ValueError(REFUSED[name])
    if name in VARIANTS:
        return name
    if name in _ALIASES:
        return _ALIASES[name]
    raise ValueError(f"unknown K3 variant {name!r}: expected one of "
                     f"{VARIANTS} or a JAX name of {sorted(_ALIASES)}")


def k3_team(d: int) -> int:
    """The team size K3 takes at width d on its vector path
    (``gn::team_size(d, 4)``)."""
    return 8 if d <= 32 else (16 if d <= 64 else 32)


def outputs(variant: str, store_sums: bool = False) -> tuple:
    """The tensors a variant writes."""
    if variant == "walk_only":
        return ("walk_v", "walk_u")
    if variant in ("full", "fixed_rows") or (variant == "sums_unstored"
                                             and store_sums):
        return ("e_out", "sum_v", "sum_u")
    return ("e_out",)


def _words(idx, pay, n: int):
    """int32 words: the sum of ``pay`` (int64) over the slots of each node
    of ``idx``, wrapping as the kernel's 32-bit unsigned adds do."""
    w = torch.zeros(n, dtype=torch.int64, device=pay.device)
    w.index_add_(0, idx.long(), pay)
    return ((w + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def k3_ablate_plain(variant, u_idx, v_idx, proj_u, proj_v, b3e, e_in, bn,
                    store_sums: bool = False) -> dict:
    """Plain PyTorch versions of the variants, on ``ops.kernels``' K3
    arithmetic; returns ``{name: tensor}`` for ``outputs(variant)``:

    - ``full``, ``edge_only``, ``sums_unstored``: ``k3_edge_stage_plain``'s
      ``e_out, sum_v, sum_u`` (those the variant writes);
    - ``fixed_rows``: K3's arithmetic with each team's own node's rows,
      ``x = (B1h[v] + B2h[v]) + b3e``, ``sum_v[v] += [sigma * A2h[v] |
      sigma]``, ``sum_u[u] += [sigma * A3h[u] | sigma]``;
    - ``stream_only``: ``e_out = ((b3e + e_in) + B1h[u]) + B2h[v]``;
    - ``walk_only``: ``walk_v[v]`` the sum over the slots s of v of ``s +
      u[s]``, ``walk_u[u]`` that of ``s + v[s]``, in int32, wrapping.

    In bfloat16 each operation rounds to bf16, as in ``ops.kernels``."""
    variant = variant_name(variant)
    d, n = b3e.shape[1], proj_u.shape[0]
    if variant == "walk_only":
        s = torch.arange(b3e.shape[0], dtype=torch.int64, device=b3e.device)
        return {"walk_v": _words(v_idx, s + u_idx.long(), n),
                "walk_u": _words(u_idx, s + v_idx.long(), n)}
    if variant == "stream_only":
        return {"e_out": ((b3e + e_in) + proj_u.index_select(0, u_idx)[:, :d])
                + proj_v.index_select(0, v_idx)[:, :d]}
    if variant == "fixed_rows":
        gu = proj_u.index_select(0, v_idx)
        e_out, sum_v, sum_u = K.k3_rows_plain(
            u_idx, v_idx, gu[:, :d], gu[:, d:],
            proj_v.index_select(0, v_idx)[:, :d],
            proj_v.index_select(0, u_idx)[:, d:], b3e, e_in, bn, n)
    else:
        e_out, sum_v, sum_u = K.k3_edge_stage_plain(u_idx, v_idx, proj_u,
                                                    proj_v, b3e, e_in, bn)
    got = {"e_out": e_out, "sum_v": sum_v, "sum_u": sum_u}
    return {k: got[k] for k in outputs(variant, store_sums)}


def k3_ablate(variant, u_idx, v_idx, v_csr, u_csr, proj_u, proj_v, b3e,
              e_in, bn, team: int | None = None, stages: int = STAGES,
              store_sums: bool = False) -> dict:
    """A K3 variant (``csrc/probes/k3_ablate.cu``) with the tensor contract
    of ``ops.kernels.k3_edge_stage``, at team size ``team`` (None: K3's own
    at this width) and ring depth ``stages``; ``store_sums`` makes
    ``sums_unstored`` store its sums.  Returns what ``k3_ablate_plain``
    returns.  float32 or bfloat16; the vector path only (d divisible by 4,
    rows aligned to four elements)."""
    variant = variant_name(variant)
    if proj_u.device.type == "cpu":
        return k3_ablate_plain(variant, u_idx, v_idx, proj_u, proj_v, b3e,
                               e_in, bn, store_sums)
    if proj_u.device.type != "cuda":
        raise ValueError(f"K3 ablate: unsupported device {proj_u.device}")
    dev = proj_u.device
    E, d = b3e.shape
    n = proj_u.shape[0]
    team = k3_team(d) if team is None else team
    if (variant, team, stages) not in INSTANCES:
        raise ValueError(f"K3 ablate: ({variant}, team {team}, stages "
                         f"{stages}) is not built; built: "
                         f"{sorted(INSTANCES)}")
    if E == 0 or n == 0:
        raise ValueError("K3 ablate: a graph without edges")
    dt, i32 = K._edge_dtype("K3 ablate", b3e), torch.int32
    K._check("proj_u", proj_u, dt, (n, 2 * d), dev, rows_contiguous=False)
    K._check("proj_v", proj_v, dt, (n, 2 * d), dev, rows_contiguous=False)
    for name, t in (("b3e", b3e), ("e_in", e_in)):
        K._check(name, t, dt, (E, d), dev)
    K._check("bn", bn, dt, (4, d), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        K._check(name, t, i32, (E,), dev)
    K._check_csr(v_csr, u_csr, n, E, dev)
    keys = outputs(variant, store_sums)
    out = {}
    for k in keys:
        shape = {"e_out": (E, d), "walk_v": (n,), "walk_u": (n,)}.get(
            k, (n, 2 * d))
        out[k] = torch.empty(shape, dtype=i32 if k.startswith("walk")
                             else dt, device=dev)
    ptr = lambda k: K._ptr(out.get(k))     # noqa: E731
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.gn_k3_ablate(
            VARIANTS.index(variant), team, stages, n, d, *map(K._ptr, v_csr),
            *map(K._ptr, u_csr), K._ptr(proj_u), proj_u.stride(0),
            K._ptr(proj_v), proj_v.stride(0), K._ptr(b3e), K._ptr(e_in),
            K._ptr(bn), ptr("e_out"), ptr("sum_v"), ptr("sum_u"),
            int(store_sums), ptr("walk_v"), ptr("walk_u"),
            int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc == _NOT_BUILT:
        raise RuntimeError(f"K3 ablate: the library lacks ({variant}, "
                           f"{team}, {stages}), which INSTANCES lists")
    if rc == _NOT_VECTOR:
        raise ValueError("K3 ablate: needs d divisible by 4 and rows "
                         "aligned to four elements (the vector path)")
    raise_on(rc, f"K3 ablate {variant}")
    k3_ablate.launches += 1
    return out


k3_ablate.launches = 0


def cost(variant: str, n: int, E: int, d: int, es: int,
         store_sums: bool = False):
    """The least bytes and float32 operations of what a variant computes
    (inputs read once, outputs written once, ``es`` bytes a row element,
    int32 indices): ``full`` and ``fixed_rows`` as K3 (chip_smoke.py
    ``k3_cost``: both [N, 2d] projections, b3e, e_in, bn, e_out, both
    [N, 2d] sums, both walks' row pointers and partners and the u side's
    permutation; ~20 operations per edge and feature); ``sums_unstored``
    without the sums' writes; ``edge_only`` the gate columns, b3e, e_in,
    bn, e_out and the v walk (8 operations: gate, BatchNorm, relu,
    residual); ``stream_only`` B1h, B2h, b3e, e_in, e_out and the v walk
    (3 adds); ``walk_only`` both walks and a word per node and pass."""
    walk_v = 4 * (E + n + 1)                   # v_ptr, v_nbr
    walk_u = 4 * (2 * E + n + 1)               # u_ptr, u_perm, u_nbr
    if variant == "walk_only":
        return walk_v + walk_u + 4 * 2 * n, 0.0
    if variant == "stream_only":
        return es * (2 * n * d + 3 * E * d) + walk_v, 3.0 * E * d
    if variant == "edge_only":
        return es * (2 * n * d + 3 * E * d + 4 * d) + walk_v, 8.0 * E * d
    sums = es * 2 * n * 2 * d if "sum_v" in outputs(variant,
                                                    store_sums) else 0
    return (es * (2 * n * 2 * d + 3 * E * d + 4 * d) + sums + walk_v + walk_u,
            20.0 * E * d)


def inputs(n: int, E: int, d: int, dtype, device, seed: int = 0):
    """K3's inputs from ``seed``: ``proj_u, proj_v`` [N, 2d], ``b3e, e_in``
    [E, d] and ``bn`` [4, d] (float32: eval BatchNorm rows [mean, rsqrt(var
    + eps), gamma, beta]; bfloat16: the folded affine [0, 1, scale, bias])."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=gen)

    def rand(*shape):
        return torch.rand(*shape, device=device, generator=gen)

    proj_u, proj_v = randn(n, 2 * d), randn(n, 2 * d)
    b3e, e_in = randn(E, d), randn(E, d)
    if dtype == torch.bfloat16:
        bn = torch.stack([torch.zeros(d, device=device),
                          torch.ones(d, device=device), rand(d) + 0.5,
                          randn(d) * 0.1])
    else:
        bn = torch.stack([randn(d) * 0.3, rand(d) * 1.5 + 0.5, rand(d) + 0.5,
                          randn(d) * 0.1])
    return tuple(t.to(dtype) for t in (proj_u, proj_v, b3e, e_in, bn))


def default_specs(d: int) -> list:
    """Every variant at K3's own team size and depth, then ``full`` at the
    other team sizes and at depths 2 and 4."""
    t = k3_team(d)
    return ([(v, t, STAGES) for v in VARIANTS]
            + [("full", x, STAGES) for x in TEAMS if x != t]
            + [("full", t, p) for p in (2, 4)])


def parse_specs(text: str, d: int) -> list:
    """``NAME[:TEAM[:STAGES]],...`` (JAX names allowed; an empty team or
    depth is K3's own) as (variant, team, stages) triples, each one that
    the library instantiates."""
    specs = []
    for item in filter(None, text.split(",")):
        name, team, stages = (item.split(":") + ["", ""])[:3]
        spec = (variant_name(name), int(team) if team else k3_team(d),
                int(stages) if stages else STAGES)
        if spec not in INSTANCES:
            raise ValueError(f"{item!r} at d={d}: {spec} is not built; "
                             f"built: {sorted(INSTANCES)}")
        specs.append(spec)
    return specs


def sweep(g, d: int, dtype, specs, reps: int = 10, seed: int = 0) -> list:
    """Time each (variant, team, stages) of ``specs`` on the device graph
    ``g`` at width ``d`` (inputs from ``seed``); one row per spec, with
    ``full`` at K3's own team size and depth timed first as the share's
    yardstick."""
    dev = g.src.device
    args = inputs(g.n_nodes, g.n_edges, d, dtype, dev, seed)
    u, v, v_csr, u_csr = g.roles(False)
    ref = ("full", k3_team(d), STAGES)
    specs = [ref] + [s for s in specs if s != ref]
    times = {}
    for variant, team, stages in specs:
        times[(variant, team, stages)] = time_ms(
            lambda: k3_ablate(variant, u, v, v_csr, u_csr, *args, team=team,
                              stages=stages), dev, reps)
    es = 2 if dtype == torch.bfloat16 else 4
    rows = []
    for (variant, team, stages), ms in times.items():
        nbytes, flops = cost(variant, g.n_nodes, g.n_edges, d, es)
        b_ms, b_by = bound(nbytes, flops)
        row = {"probe": "k3_ablate", "variant": variant,
               "jax": list(JAX_NAMES[variant]), "team": team,
               "stages": stages, "d": d, "dtype": str(dtype).split(".")[1],
               "nodes": g.n_nodes, "edges": g.n_edges,
               **device_label(dev), "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes}
        rows.append(timed(row, dev, ms, medges_per_s=g.n_edges / ms / 1e3,
                          share_of_full=ms / times[ref],
                          over_bound=ms / b_ms))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=262_144)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", default="",
                    help="NAME[:TEAM[:STAGES]],... (default: every variant "
                         "at K3's team size and depth, then the sweeps)")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..graphs.synthetic import random_bench_graph
    from ..ops import DeviceGraph

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device (--device cpu runs the plain versions)")
    specs = (parse_specs(args.variants, args.width) if args.variants
             else default_specs(args.width))
    src, dst = random_bench_graph(args.nodes, 6.0, seed=0)
    g = DeviceGraph.build(src, dst, args.nodes, dev)
    dtype = getattr(torch, args.dtype)
    for row in sweep(g, args.width, dtype, specs, args.reps, args.seed):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
