"""gnnome_tpu_torch/parallel/projection.py: the bytes and calls it counts
for a halo eval forward (with the gather of its logits) and a halo train
step equal, exactly, what ``Group.sent`` and ``Group.calls`` record on
gloo CPU ranks at P = 2 and 4, in float32 and bf16, with and without the
symmetry loss, on a graph with strips and overflow rows and (P = 4) on one
of fewer RC pairs than ranks (K = 0, an empty block); the serial model's
arithmetic; and scripts/torch_scaling_projection.py's output, which says
it is a model.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gnnome_tpu_torch.config import Config
from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.models.convert import pytrees_from_model
from gnnome_tpu_torch.models.features import edge_features, node_features
from gnnome_tpu_torch.models.zoo import get_model
from gnnome_tpu_torch.parallel import checks
from gnnome_tpu_torch.parallel.group import spawn
from gnnome_tpu_torch.parallel.halo import plan_graph
from gnnome_tpu_torch.parallel.projection import (LINKS, Traffic,
                                                  forward_traffic, project)
from gnnome_tpu_torch.train.step import host_units
from torch_recipes import check_wire_counts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_scaling_projection.py")
MODEL = dict(num_gnn_layers=3, dim_latent=16, hidden_edge_scores=16,
             dropout=0.0)
GRAPHS = {"overflow": dict(n_reads=512, genome_len=40000, read_len=500,
                           seed=61, with_sequences=True,
                           false_edge_frac=0.01),
          "few_pairs": dict(n_reads=3, genome_len=1500, read_len=600,
                            seed=1, with_sequences=True)}


def _cfg(dtype="float32", symmetry=True):
    cfg = Config()
    cfg.compute.device = "cpu"
    cfg.compute.dtype = dtype
    for k, v in MODEL.items():
        setattr(cfg.model, k, v)
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 10 ** 6
    cfg.train.use_symmetry_loss = symmetry
    return cfg


@pytest.fixture(scope="module")
def inputs():
    model = get_model(_cfg().model).init_weights(3)
    params, state = pytrees_from_model(model)
    n_params = sum(p.numel() for p in model.parameters())
    out = {}
    for name, kw in GRAPHS.items():
        g, _, _, _ = synthetic_assembly_graph(**kw)
        (unit,) = host_units(g, _cfg(), np.random.default_rng(0))
        out[name] = (g, unit)
    return out, params, state, n_params


CASES = [("float32", True), ("bfloat16", True), ("float32", False)]


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def ranks(request, inputs):
    P = request.param
    graphs, params, state, _ = inputs
    names = ["overflow"] + (["few_pairs"] if P == 4 else [])
    jobs, keys = [], []
    for name in names:
        g, unit = graphs[name]
        for dtype, sym in CASES:
            cfg = _cfg(dtype, sym)
            if sym:
                jobs.append((checks.score_job, (
                    g.src, g.dst, g.num_nodes, node_features(g),
                    edge_features(g), params, state, cfg)))
                keys.append((name, "forward", dtype, sym))
            jobs.append((checks.train_step_job,
                         (unit, params, state, cfg, 1.3)))
            keys.append((name, "step", dtype, sym))
    res = spawn(checks.run_jobs, P, jobs, deadline_s=600)
    return P, {k: [r[i] for r in res] for i, k in enumerate(keys)}


def test_counts_equal_the_groups(ranks, inputs):
    P, by_key = ranks
    graphs, _, _, n_params = inputs
    d, L = MODEL["dim_latent"], MODEL["num_gnn_layers"]
    seen = set()
    for (name, kind, dtype, sym), res in by_key.items():
        g, _ = graphs[name]
        plan, _ = plan_graph(g.src, g.dst, g.num_nodes, P)
        check_wire_counts(res, plan, kind, d, L, n_params,
                          passes=2 if sym else 1)
        seen.add((name, plan.K > 0, plan.R > 0))
    # strips and overflow rows both counted; at P = 4 a plan with K = 0
    assert ("overflow", True, True) in seen
    if P == 4:
        assert any(n == "few_pairs" and not k for n, k, _ in seen)


def test_wire_counts_every_rank_it_reaches(inputs):
    """A ring all-gather's payload reaches every other rank; the logits'
    gather brings P - 1 payloads to rank 0."""
    graphs, _, _, _ = inputs
    g, _ = graphs["overflow"]
    plan, _ = plan_graph(g.src, g.dst, g.num_nodes, 4)
    t0, t1 = (forward_traffic(plan, r, 16, 3) for r in (0, 1))
    kl, kr = plan.strips(1)
    rows = int(np.diff(plan.cuts).max())
    strips = (kl + kr) * (3 * 16 * 3 + 16) * 4
    overflow = plan.R * (3 * 16 * 3 + 16) * 4
    assert t1.sent == {"p2p": strips, "collective": overflow + rows * 4}
    assert t1.wire == strips + 3 * overflow + rows * 4
    assert t0.wire - t0.sent["p2p"] == 3 * overflow + 3 * rows * 4


def test_serial_model_arithmetic():
    class Plan:
        n_parts, K, R, route = 4, 10, 2, "banded"

    quiet = Traffic({"p2p": 100, "collective": 20}, {"p2p": 3,
                                                     "collective": 2}, 1000)
    busy = Traffic({"p2p": 200, "collective": 20}, {"p2p": 3,
                                                    "collective": 4}, 5000)
    lat = {"p2p": 1e-3, "collective": 2e-3}
    p = project(0.08, Plan, [quiet, busy, quiet, quiet], 1e6, lat)
    assert p.t_compute_s == pytest.approx(0.02)
    assert p.t_wire_s == pytest.approx(5e-3)
    assert p.t_latency_s == pytest.approx(3e-3 + 8e-3)
    assert p.t_step_s == pytest.approx(0.02 + 5e-3 + 11e-3)
    assert p.efficiency == pytest.approx(0.08 / (4 * p.t_step_s))
    assert p.wire_bytes == 5000 and p.calls == {"p2p": 3, "collective": 4}
    assert LINKS == {"nvlink4": 450e9, "ndr_ib": 50e9}


def test_script_says_it_is_a_model(tmp_path):
    out = tmp_path / "p.json"
    run = subprocess.run(
        [sys.executable, SCRIPT, "--latency-ms", "0.05", "--configs",
         "1_ecoli_infer", "--eval-ms", "1_ecoli_infer=3.0", "--device",
         "cpu", "--out", str(out)], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
    assert run.returncode == 0, run.stderr
    rows = [line for line in run.stdout.splitlines() if line.startswith("|")
            and not line.startswith("|---")][1:]
    kind = "projection (a model, not a measurement)"
    assert len(rows) == 3 and all(kind in r for r in rows)
    res = json.loads(out.read_text())
    assert res["kind"] == kind
    c = res["configs"]["1_ecoli_infer"]
    assert c["t1_source"] == "given" and c["t1_ms"] == 3.0
    assert [p["P"] for p in c["curve"]] == [2, 4, 8]
    assert res["latency"]["collective"] == pytest.approx(5e-5)
    for p in c["curve"]:
        assert p["t_step_s"] == pytest.approx(
            p["t_compute_s"] + p["t_wire_s"] + p["t_latency_s"])


def test_script_needs_a_latency(tmp_path):
    run = subprocess.run([sys.executable, SCRIPT, "--device", "cpu"],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
    assert run.returncode != 0
    assert "--latency-ms" in run.stderr
