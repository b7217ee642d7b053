"""The card probes of gnnome_tpu_torch (``gnnome_tpu_torch/probes``) on the
CPU, where their wrappers run the plain versions, against the JAX package's
TPU probe scripts.

- ``k3_ablate``: each variant's plain version against ``scripts/
  k3_ablate.py``'s ``run_variant`` where the two compute the same function:
  ``full`` (e_out, and the node sums read back through the windowed plan's
  block map) and ``no_scatter`` / ``edge_only`` (e_out).  ``run_variant``
  runs in Pallas interpret mode: the test wraps ``pallas_call`` with
  ``interpret=True`` through ``monkeypatch`` for its own duration, as
  tests/test_pallas.py sets the package's interpret flag; no file of
  ``gnnome_tpu/`` or ``scripts/`` changes.  ``run_variant`` reads the
  plan's per-slot local indices as an ``[Ep, 1]`` column (the layout the
  script was written for), so the test hands it the plan's lane-major
  indices in slot order.  Inputs: the JAX probe's bf16 rows (normal, from
  a numpy seed) and folded affine, on a small banded graph whose plan has
  no overflow edge.  Tolerances: e_out within one bf16 spacing (2^-7 of
  the value; the operations are the same, and the two agree bit for bit
  on this graph); node sums within two bf16 spacings of the summed
  magnitudes: sigma is computed in float32 by two libraries, and where
  their float32 values round to neighbouring bf16 values a term moves by
  one spacing and its rounded product by one more (measured: 1.4
  spacings), and the port rounds its float32 sum to bf16 once.
- ``stream_only`` and ``fixed_rows`` compute card-specific functions (the
  JAX ``dma_only`` adds row 0 of a window, ``static_in`` reads fixed
  windows), so they are held against the numpy formulas of their
  docstrings, as is ``walk_only``; ``full``'s plain version is
  ``ops.kernels.k3_edge_stage_plain`` bit for bit.
- ``dma_probe``: ``stream_sum_plain`` against the same left-to-right sum
  in ``jax.numpy``, chained ``reps`` times with the output fed back as
  input 0, float32 and bf16, bit for bit (the same adds in the same
  order; eager ``jnp`` rounds each add).  The JAX kernel itself (``kern``,
  ``scripts/dma_probe.py:24``) is local to ``run``, which returns nothing,
  so it cannot be called.
- Both probes' command lines run in CPU mode and print parseable lines;
  the TPU-only variant names are refused with their reason.
"""
import functools
import importlib.util
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gnnome_tpu.ops.graph_tensors import GraphTensors
from gnnome_tpu.ops.windowed import build_windowed_plan

from gnnome_tpu_torch.ops import DeviceGraph
from gnnome_tpu_torch.ops import kernels as K
from gnnome_tpu_torch.probes import dma_probe
from gnnome_tpu_torch.probes import k3_ablate as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPACING = 2.0 ** -7          # a bf16 value's spacing is at most this x |value|
TILE_E, WINDOW, CHUNK, D = 256, 128, 128, 64
N_NODES = 700


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "k3_ablate_tpu_probe", os.path.join(ROOT, "scripts", "k3_ablate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """``pl.pallas_call`` in interpret mode for this test only."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def banded_graph(n=N_NODES, seed=3):
    """Edges u -> u + 1..11 inside [0, n): spans the windowed plan covers
    without overflow."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 6 * n)
    dst = src + rng.integers(1, 12, src.size)
    keep = dst < n
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


def column_plan(plan):
    """The plan as ``run_variant`` reads it: local indices as [Ep, 1]
    columns in slot order."""
    rows = plan.tile_e // plan.chunk

    def col(local):
        a = np.asarray(local).reshape(plan.n_tiles, plan.rows_p, plan.chunk)
        return jnp.asarray(a[:, :rows, :].reshape(-1, 1))

    return types.SimpleNamespace(
        n_tiles=plan.n_tiles, tile_e=plan.tile_e, window=plan.window,
        n_blocks=plan.n_blocks, u_blk=plan.u_blk, v_blk=plan.v_blk,
        u_local=col(plan.u_local), v_local=col(plan.v_local))


def block_sums(out, plan, visited, n):
    """Node sums from the probe's window-block outputs: block b's rows
    [0, 2W) are nodes [b W, b W + 2W); unvisited blocks are never
    written."""
    W = plan.window
    o = np.asarray(out, np.float64).reshape(plan.n_blocks, 2 * W, -1)
    acc = np.zeros((plan.n_blocks * W + W, o.shape[2]))
    for b in np.nonzero(np.asarray(visited))[0]:
        acc[b * W: b * W + 2 * W] += o[b]
    return acc[:n]


def to_torch(a, rows=None):
    a = np.asarray(a.astype(jnp.float32))
    return torch.from_numpy(np.array(a[:rows])).to(torch.bfloat16)


@pytest.mark.parametrize("flip", [False, True])
def test_k3_variants_match_jax_probe(interpret, flip):
    mod = _jax_probe()
    src, dst = banded_graph()
    E = src.size
    gt = GraphTensors.build(src, dst, N_NODES, edge_pad_multiple=TILE_E,
                            node_pad_multiple=WINDOW)
    plan = build_windowed_plan(gt, flip=flip, tile_e=TILE_E, window=WINDOW,
                               chunk=CHUNK)
    assert plan.n_ovf == 0 and plan.window_v == WINDOW
    Np, Ep = gt.n_nodes_pad, gt.n_edges_pad
    rng = np.random.default_rng(11)
    bf = jnp.bfloat16
    proj_u = jnp.asarray(rng.normal(size=(Np, 2 * D)), bf)
    proj_v = jnp.asarray(rng.normal(size=(Np, 2 * D)), bf)
    b3e = jnp.asarray(rng.normal(size=(Ep, D)), bf)
    e_in = jnp.asarray(rng.normal(size=(Ep, D)), bf)
    scale = jnp.asarray(rng.uniform(0.5, 1.5, D), bf)
    bias = jnp.asarray(rng.normal(size=D) * 0.1, bf)
    affine = jnp.zeros((8, D), bf).at[0].set(scale).at[1].set(bias)
    emask = jnp.asarray(np.asarray(gt.edge_mask), bf)
    cplan = column_plan(plan)
    eo, pu_out, pv_out = mod.run_variant(cplan, "full", proj_u, proj_v, b3e,
                                         e_in, affine, emask, CHUNK, d=D)
    eo_ns, _, _ = mod.run_variant(cplan, "no_scatter", proj_u, proj_v, b3e,
                                  e_in, affine, emask, CHUNK, d=D)

    g = DeviceGraph.build(src, dst, N_NODES)
    u, v, _, _ = g.roles(flip)
    bn = torch.stack([torch.zeros(D), torch.ones(D), to_torch(scale).float(),
                      to_torch(bias).float()]).to(torch.bfloat16)
    args = (u, v, to_torch(proj_u, N_NODES), to_torch(proj_v, N_NODES),
            to_torch(b3e, E), to_torch(e_in, E), bn)
    full = P.k3_ablate_plain("full", *args)
    edge = P.k3_ablate_plain("no_scatter", *args)
    assert set(edge) == {"e_out"}

    def edges_close(got, ref):
        got, ref = got.float().numpy(), np.asarray(ref, np.float32)[:E]
        assert np.all(np.abs(got - ref) <= SPACING * np.abs(ref))

    edges_close(full["e_out"], eo)
    edges_close(edge["e_out"], eo_ns)
    # the summed magnitudes of each node's terms, in float64
    sig = torch.sigmoid(full["e_out"].float()).to(torch.bfloat16)
    for side, idx, other, a_col, out, vis in (
            ("sum_v", v, u, args[2], pv_out, plan.v_visited),
            ("sum_u", u, v, args[3], pu_out, plan.u_visited)):
        a = a_col.index_select(0, other)[:, D:]
        terms = torch.cat([(sig * a).double(), sig.double()], 1).abs()
        mag = torch.zeros(N_NODES, 2 * D, dtype=torch.float64).index_add_(
            0, idx, terms).numpy()
        ref = block_sums(out, plan, vis, N_NODES)
        got = full[side].double().numpy()
        assert np.all(np.abs(got - ref) <= 2 * SPACING * mag + 1e-12), side


def small_case(dtype, d=16, n=60, seed=5):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 5 * n)
    dst = rng.integers(0, n, 5 * n)
    keep = src != dst
    g = DeviceGraph.build(src[keep], dst[keep], n)
    E = g.n_edges
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    bn = torch.stack([t(d) * 0.3, torch.rand(d) + 0.5, torch.rand(d) + 0.5,
                      t(d) * 0.1])
    rows = (t(n, 2 * d), t(n, 2 * d), t(E, d), t(E, d), bn)
    return g, tuple(r.to(dtype) for r in rows)


def as_np(t, dtype):
    """A tensor as numpy in ``dtype`` (ml_dtypes' bfloat16 rounds each
    numpy operation to bf16, as the kernels do)."""
    return t.float().numpy().astype(dtype)


@pytest.mark.parametrize("dtype,npdt", [(torch.float32, np.float32),
                                        (torch.bfloat16, ml_dtypes.bfloat16)])
@pytest.mark.parametrize("flip", [False, True])
def test_stream_only_and_fixed_rows_formulas(dtype, npdt, flip):
    g, (pu, pv, b3e, e_in, bn) = small_case(dtype)
    d = b3e.shape[1]
    u, v, _, _ = g.roles(flip)
    un, vn = u.numpy(), v.numpy()
    args = (u, v, pu, pv, b3e, e_in, bn)
    got = P.k3_ablate_plain("stream_only", *args)
    PU, PV, B3, EI = (as_np(x, npdt) for x in (pu, pv, b3e, e_in))
    ref = ((B3 + EI) + PU[un, :d]) + PV[vn, :d]
    assert set(got) == {"e_out"}
    np.testing.assert_array_equal(got["e_out"].float().numpy(),
                                  ref.astype(np.float32))
    # fixed_rows: K3's arithmetic on the rows of each team's own node
    fr = P.k3_ablate_plain("fixed_rows", *args)
    ref_e, ref_v, ref_u = K.k3_rows_plain(
        u, v, pu[v][:, :d], pu[v][:, d:], pv[v][:, :d], pv[u][:, d:], b3e,
        e_in, bn, g.n_nodes)
    for k, r in (("e_out", ref_e), ("sum_v", ref_v), ("sum_u", ref_u)):
        assert torch.equal(fr[k], r), k
    # ... and its gate in numpy
    x = (PU[vn, :d] + PV[vn, :d]) + as_np(b3e, npdt)
    BN = as_np(bn, npdt)
    y = ((x - BN[0]) * BN[1]) * BN[2] + BN[3]
    eo = np.maximum(y, npdt(0)) + EI
    np.testing.assert_array_equal(fr["e_out"].float().numpy(),
                                  eo.astype(np.float32))


@pytest.mark.parametrize("flip", [False, True])
def test_walk_only_formula(flip):
    g, args = small_case(torch.float32)
    u, v, _, _ = g.roles(flip)
    got = P.k3_ablate_plain("walk_only", u, v, *args)
    un, vn = u.numpy().astype(np.int64), v.numpy().astype(np.int64)
    s = np.arange(un.size)
    for key, idx, other in (("walk_v", vn, un), ("walk_u", un, vn)):
        ref = np.zeros(g.n_nodes, np.int64)
        np.add.at(ref, idx, s + other)
        np.testing.assert_array_equal(got[key].numpy(),
                                      ref.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_and_knockouts_equal_k3_plain(dtype):
    g, rows = small_case(dtype)
    u, v, v_csr, u_csr = g.roles(False)
    ref = K.k3_edge_stage_plain(u, v, *rows)
    full = P.k3_ablate("full", u, v, v_csr, u_csr, *rows)
    assert all(torch.equal(full[k], r)
               for k, r in zip(("e_out", "sum_v", "sum_u"), ref))
    assert set(P.k3_ablate("sums_unstored", u, v, v_csr, u_csr,
                           *rows)) == {"e_out"}
    kept = P.k3_ablate("sums_unstored", u, v, v_csr, u_csr, *rows,
                       store_sums=True)
    assert all(torch.equal(kept[k], full[k]) for k in full)
    for name in ("edge_only", "no_scatter", "noout", "dma_noout"):
        got = P.k3_ablate(name, u, v, v_csr, u_csr, *rows)
        assert set(got) == {"e_out"} and torch.equal(got["e_out"],
                                                     full["e_out"]), name
    assert P.k3_ablate.launches == 0          # the CPU runs no kernel


@pytest.mark.parametrize("name", ["per_tile", "full_reuse"])
def test_tpu_layout_variants_refused(name):
    g, rows = small_case(torch.float32)
    u, v, v_csr, u_csr = g.roles(False)
    with pytest.raises(ValueError, match="window partials"):
        P.k3_ablate(name, u, v, v_csr, u_csr, *rows)
    with pytest.raises(ValueError, match="no counterpart"):
        P.parse_specs(f"{name}:16:3", 64)


def test_specs_and_costs():
    assert P.default_specs(64)[0] == ("full", 16, 3)
    assert all(s in P.INSTANCES for d in (64, 128)
               for s in P.default_specs(d))
    assert P.parse_specs("no_scatter,full:8:3,full::4", 64) == [
        ("edge_only", 16, 3), ("full", 8, 3), ("full", 16, 4)]
    with pytest.raises(ValueError, match="not built"):
        P.parse_specs("walk_only:8:3", 64)
    # full's bytes are chip_smoke.py's k3_cost: both projections and sums,
    # three edge streams, bn, the walks' int32 arrays
    n, E, d = 100, 600, 64
    want = 4 * (2 * n * 2 * d + 3 * E * d + 4 * d + 2 * n * 2 * d) \
        + 4 * (3 * E + 2 * (n + 1))
    assert P.cost("full", n, E, d, 4) == (want, 20.0 * E * d)
    assert P.cost("sums_unstored", n, E, d, 4)[0] == want - 4 * 2 * n * 2 * d
    assert P.cost("walk_only", n, E, d, 4)[0] == 4 * (3 * E + 2 * (n + 1)
                                                      + 2 * n)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 4, 12])
def test_stream_sum_plain_matches_jnp_chain(dtype, k):
    T, ET, d, reps = 4, 8, 64, 3
    rng = np.random.default_rng(k)
    xs = [rng.normal(size=(T * ET, d)).astype(np.float32) for _ in range(k)]
    jx = [jnp.asarray(x, dtype) for x in xs]

    def jnp_sum(ins):              # the JAX kern's body, eagerly
        acc = ins[0]
        for r in ins[1:]:
            acc = acc + r
        return acc

    ref = jx[0]
    for _ in range(reps):
        ref = jnp_sum([ref, *jx[1:]])
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
          for x in jx]
    got = dma_probe.chain(dma_probe.stream_sum, tx, T, ET, reps)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert dma_probe.stream_sum.launches == 0


def test_stream_sum_checks():
    x = torch.zeros(32, 64)
    with pytest.raises(ValueError, match="inputs"):
        dma_probe.stream_sum([x] * 13, 4, 8)
    with pytest.raises(ValueError, match="T \\* ET"):
        dma_probe.stream_sum([x], 4, 16)
    with pytest.raises(TypeError):
        dma_probe.stream_sum([x, x.double()], 4, 8)
    assert dma_probe.cost(4, 10, 64, 2) == (5 * 10 * 64 * 2, 3.0 * 10 * 64)


@pytest.mark.parametrize("argv,n_lines", [
    (["gnnome_tpu_torch.probes.k3_ablate", "--nodes", "2048", "--reps", "1"],
     len(P.default_specs(64))),
    (["gnnome_tpu_torch.probes.dma_probe", "--reps", "2", "--et-divisor",
      "256"], 9)])
def test_probe_command_lines_on_cpu(argv, n_lines):
    out = subprocess.run([sys.executable, "-m", *argv, "--device", "cpu"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    rows = [json.loads(ln) for ln in out.stdout.splitlines()]
    assert len(rows) == n_lines
    for r in rows:
        assert r["device"] == "cpu" and r["kernel"] == "plain"
        assert r["cpu_ms"] > 0 and "ms" not in r and r["bound_ms"] > 0


# two forms of the ``-Xptxas -v`` report: CUDA 12's (barriers, no cmem)
# and the older one (smem and cmem on the "Used" line); every entry
# function has a properties line and a "Used" line
PTXAS_LOGS = {
    "barriers": (
        "== probes/mosaic_ops.cu (rc=0)\n"
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112small_"
        "matmulIfLb1EEEviiiPKT_lS3_lPS1_l' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_112small_"
        "matmulIfLb1EEEviiiPKT_lS3_lPS1_l\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 80 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110row_"
        "gatherIfEEviiiPKiPKT_lPS3_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_110row_"
        "gatherIfEEviiiPKiPKT_lPS3_\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 16 registers, used 0 barriers\n"
        "== probes/stream_sum.cu (rc=0)\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110stream_"
        "sumILi12ELb1EEEvNS_6InputsEP5uint4il' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_110stream_"
        "sumILi12ELb1EEEvNS_6InputsEP5uint4il\n"
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, used 0 barriers\n"),
    "cmem": (
        "ptxas info    : Compiling entry function '_Z12small_matmulI13__nv_"
        "bfloat16Lb0EEviiiPKT_lS3_lPS1_l' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z12small_matmulI13__nv_"
        "bfloat16Lb0EEviiiPKT_lS3_lPS1_l\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 56 registers, 2176 bytes smem, 400 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z10stream_sumILi1ELb0EEv"
        "6InputsP5uint4il' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z10stream_sumILi1ELb0EEv"
        "6InputsP5uint4il\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 30 registers, 384 bytes cmem[0]\n"),
}


@pytest.mark.parametrize("form", sorted(PTXAS_LOGS))
def test_ptxas_resources_reads_each_instantiation(form):
    from gnnome_tpu_torch.probes import ptxas_resources

    log = PTXAS_LOGS[form]
    got = ptxas_resources(log, ("small_matmul", "stream_sum"))
    keep = ("registers", "stack_bytes", "spill_stores", "spill_loads",
            "smem_bytes")
    want = {"barriers": [(80, 0, 0, 0, 0), (255, 8, 12, 16, 0)],
            "cmem": [(56, 0, 0, 0, 2176), (30, 0, 0, 0, 0)]}[form]
    assert [tuple(r[k] for k in keep) for r in got] == want
    assert ["small_matmul" in r["function"] for r in got] == [True, False]
    other = ptxas_resources(log, ("row_gather",))
    assert [r["registers"] for r in other] == (
        [] if form == "cmem" else [16])


def test_in_turns_runs_kernel_library_library_kernel():
    from gnnome_tpu_torch.probes import in_turns

    order = []
    got = in_turns(lambda: order.append("k"), lambda: order.append("l"),
                   torch.device("cpu"), 3)
    assert order == ["k"] * 3 + ["l"] * 6 + ["k"] * 3
    assert set(got) == {"kernel_ms", "library_ms"}
    assert all(len(v) == 2 and min(v) >= 0 for v in got.values())
