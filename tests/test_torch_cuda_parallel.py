"""The port's ranks sharing one card over gloo (every message staged
through pinned host memory), held against its single-device card runs: the
halo path (``parallel/halo.py``: the batch-norm SymGatedGCN's eval forward
and train step), the sharded path (``parallel/sharded.py``: every other
model's eval forward), ``cli`` with ``compute.mesh=2``, the entry points
of ``entry.py``, two launchers of one rank each against ``spawn``, and
every rank's bytes and calls against the wire-cost model.  Every test here
is ``cuda``-marked and skips where no GPU is present; the file imports no
JAX (run it as ``tests/test_torch_cuda.py`` says).

Each P's checks run in one spawned group (``checks.run_jobs``; a spawn of
4 ranks on the shared card costs ~35 s), which the tests read.  Graphs:
the JAX bench's mesh graph (bench.py:426-432: ``random_bench_graph(65,536,
6.0)``, z-scored degrees, seeded edge features and labels) at P = 2 and 4;
the golden graph at P = 2, through the overflow-uncapped route (no banded
plan); two synthetic assembly graphs (512 reads, with no and with 1%
false edges) at P = 2; ``random_rc_bench_graph(1,048,576, 8.0)``'s eval
at P = 2 and 4; a graph of 3 RC pairs at P = 4 (one rank's block empty);
for the sharded path the golden graph at P = 2 with the layer-norm and
norm-free SymGatedGCN and each zoo model (d = 64, 8 layers, 3 GAT heads,
``init_weights(7)``), the JAX bench's ``random_bench_graph(262,144, 6.0)``
at P = 2 (layer norm) and the 3-pair graph at P = 4 (layer norm, GCN).

Bounds, set before any card run: eval logits within 1e-4 + 1e-4 |x| of
the single-device card forward (node sums and statistics add in another
order), on the synthetic graphs within 5e-5 + 1e-4 |x|, the forward
tolerance of tests/test_torch_train.py:62; a train step as the card-vs-CPU
step (``torch_recipes.check_step``: ``STEP_*``, in bf16 ``BF16_*``), the
parameters after Adam bitwise equal on every rank; the golden AP within
1e-4 of the JAX figure; per rank 8 K3 + 1 K6 per eval forward and
16/16/16/16/2/2 K7/K3/K8/edge adjoint/K6/K9 per step (two directional
passes), per sharded forward 8 K1 + 8 K2 (layer norm, none), 8 one-sided
walks (GatedGCN, GCN, SAGE) or 16 (GAT), and no launch on a rank whose
block holds no edge.
"""
import json
import os

import numpy as np
import pytest
import torch

from gnnome_tpu_torch.ops import DeviceGraph
from gnnome_tpu_torch.ops import kernels as K
from torch_recipes import cuda  # noqa: F401  (the fixture)
from torch_recipes import (AP_TOL, FEW_PAIRS_GRAPH, FORWARD_LAUNCHES, GOLDEN,
                           HALO_STEP_LAUNCHES, INFER_LEN_THRESHOLD, INIT_SEED,
                           JAX_GOLDEN_AP, K1K2_FORWARD_LAUNCHES, LOGIT_ATOL,
                           LOGIT_RTOL, OVERFIT_GRAPH, WEIGHTS,
                           ZOO_FORWARD_SIDE_SUMS, check_step,
                           check_wire_counts, expected_launches,
                           launch_two_hosts, make_infer_dataset, overfit_run,
                           write_dataset)

pytestmark = pytest.mark.cuda

HALO_BENCH = dict(num_nodes=65_536, avg_degree=6.0, seed=0)
HALO_BIG = dict(num_nodes=1_048_576, avg_degree=8.0, seed=0)
SHARDED_BENCH = dict(num_nodes=262_144, avg_degree=6.0, seed=0)
MULTIHOST_NODES = 16_384
# the synthetic assembly graphs by name: their false-edge fraction; their
# eval logits within SYNTH_LOGIT_ATOL + LOGIT_RTOL |x|
SYNTH_GRAPHS = {"synth": 0.0, "synth_false": 0.01}
SYNTH_LOGIT_ATOL = 5e-5
# `cli train` with compute.mesh=2 logs the single-device epoch's losses
HALO_TRAIN_LOSS_RTOL = 1e-4
# the sharded path's models: (model.model, normalization, directed)
SHARDED_MODELS = {"layer": ("sym_gatedgcn", "layer", True),
                  "none": ("sym_gatedgcn", "none", True),
                  "gatedgcn": ("gatedgcn", "batch", True),
                  "gatedgcn_undirected": ("gatedgcn", "batch", False),
                  "gcn": ("gcn", "batch", True),
                  "gat": ("gat", "batch", True),
                  "sage": ("sage", "batch", True)}


def _cfg(dtype: str = "float32", mid: str | None = None):
    """The halo checks' config (dropout 0, no masking, one unit a graph),
    on the card; with ``mid`` the sharded model it names."""
    from gnnome_tpu_torch.config import Config

    cfg = Config()
    cfg.compute.device = "cuda"
    cfg.compute.dtype = dtype
    cfg.model.dropout = 0.0
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 10 ** 9
    if mid is not None:
        (cfg.model.model, cfg.model.normalization,
         cfg.model.directed) = SHARDED_MODELS[mid]
    return cfg


def _unit_arrays(unit):
    """``(src, dst, n_nodes, x, e)`` of a ``HostUnit``: the z-scored (in,
    out) degree features of ``make_example``."""
    from gnnome_tpu_torch.models.features import _zscore

    x = np.stack([_zscore(unit.in_deg), _zscore(unit.out_deg)], axis=1)
    return unit.src, unit.dst, unit.n_nodes, x, unit.e_feat


@pytest.fixture(scope="module")
def inputs():
    """Weights, graphs (``(src, dst, n_nodes, x, e)``) and training units
    of every check."""
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.graphs.synthetic import (random_bench_graph,
                                                   random_rc_bench_graph)
    from gnnome_tpu_torch.models import (edge_features, get_model,
                                         load_model_weights, node_features,
                                         pytrees_from_model)
    from gnnome_tpu_torch.parallel import checks
    from gnnome_tpu_torch.train.step import host_units

    def units(g):
        (unit,) = host_units(g, _cfg(), np.random.default_rng(0))
        return unit

    def arrays(g):
        return g.src, g.dst, g.num_nodes, node_features(g), edge_features(g)

    bench = checks.bench_unit(*random_bench_graph(
        HALO_BENCH["num_nodes"], HALO_BENCH["avg_degree"],
        seed=HALO_BENCH["seed"]), HALO_BENCH["num_nodes"])
    big = random_rc_bench_graph(HALO_BIG["num_nodes"], HALO_BIG["avg_degree"],
                                seed=HALO_BIG["seed"])
    sharded_bench = checks.bench_unit(*random_bench_graph(
        SHARDED_BENCH["num_nodes"], SHARDED_BENCH["avg_degree"],
        seed=SHARDED_BENCH["seed"]), SHARDED_BENCH["num_nodes"])
    golden = AssemblyGraph.load(GOLDEN)
    few, _, _, _ = synthetic_assembly_graph(**FEW_PAIRS_GRAPH)
    synth = {name: arrays(synthetic_assembly_graph(
        n_reads=512, genome_len=40000, read_len=500, seed=77,
        false_edge_frac=frac)[0]) for name, frac in SYNTH_GRAPHS.items()}
    return {
        "weights": load_model_weights(WEIGHTS),
        "sharded_weights": {mid: pytrees_from_model(get_model(
            _cfg(mid=mid).model).init_weights(INIT_SEED))
            for mid in SHARDED_MODELS},
        "graphs": {"bench": _unit_arrays(bench),
                   "big": _unit_arrays(checks.bench_unit(
                       big.src, big.dst, big.num_nodes)),
                   "golden": arrays(golden), "few": arrays(few),
                   "sharded_bench": _unit_arrays(sharded_bench), **synth},
        "units": {"bench": bench, "golden": units(golden),
                  "few": units(few)},
        "golden_y": golden.y}


def _jobs(P: int, inputs) -> dict:
    """The P ranks' jobs by key: ``(rank function, its arguments)``."""
    from gnnome_tpu_torch.parallel import checks

    params, state = inputs["weights"]
    graphs, units = inputs["graphs"], inputs["units"]
    sw = inputs["sharded_weights"]
    jobs = {("eval", "bench"): (checks.score_job, (
                *graphs["bench"], params, state, _cfg())),
            ("step", "bench", "float32"): (checks.train_step_job, (
                units["bench"], params, state, _cfg(), 1.0)),
            ("eval", "big"): (checks.score_job, (
                *graphs["big"], params, state, _cfg()))}
    if P == 2:
        jobs.update({
            ("step", "bench", "bfloat16"): (checks.train_step_job, (
                units["bench"], params, state, _cfg("bfloat16"), 1.0)),
            ("eval", "golden"): (checks.score_job, (
                *graphs["golden"], params, state, _cfg())),
            ("step", "golden", "float32"): (checks.train_step_job, (
                units["golden"], params, state, _cfg(), 1.0)),
            ("sharded", "sharded_bench", "layer"): (checks.score_job, (
                *graphs["sharded_bench"], *sw["layer"], _cfg(mid="layer"))),
            ("multihost",): (checks.train_step_job, (
                *checks.multihost_inputs(MULTIHOST_NODES, 2, "cuda"), 1.0))})
        jobs.update({("sharded", "golden", mid): (checks.score_job, (
            *graphs["golden"], *sw[mid], _cfg(mid=mid)))
            for mid in SHARDED_MODELS})
        jobs.update({("eval", name): (checks.score_job, (
            *graphs[name], params, state, _cfg())) for name in SYNTH_GRAPHS})
    else:
        jobs.update({
            ("eval", "few"): (checks.score_job, (
                *graphs["few"], params, state, _cfg())),
            ("step", "few", "float32"): (checks.train_step_job, (
                units["few"], params, state, _cfg(), 1.0))})
        jobs.update({("sharded", "few", mid): (checks.score_job, (
            *graphs["few"], *sw[mid], _cfg(mid=mid)))
            for mid in ("layer", "gcn")})
    return jobs


@pytest.fixture(scope="module")
def groups(cuda, inputs):
    """``groups(P)``: ``{key: every rank's result}`` of the P ranks' group,
    spawned once, whatever order the tests run in."""
    import gc

    from gnnome_tpu_torch.parallel import checks
    from gnnome_tpu_torch.parallel.group import spawn

    done = {}

    def get(P):
        if P not in done:
            gc.collect()
            torch.cuda.empty_cache()        # the ranks share the card
            jobs = _jobs(P, inputs)
            res = spawn(checks.run_jobs, P, list(jobs.values()),
                        device="cuda", deadline_s=1200)
            done[P] = {key: [r[i] for r in res]
                       for i, key in enumerate(jobs)}
        return done[P]

    return get


@pytest.fixture(scope="module")
def single(cuda, inputs):
    """The single-device card runs, each computed once: ``single("eval",
    graph, mid)`` the host-order logits of the batch-norm model (``mid``
    None) or a sharded model, ``single("step", unit, dtype)`` one train
    step (its dual-width pass) from the shipped weights."""
    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models.convert import numpy_from_module_state
    from gnnome_tpu_torch.models.zoo import processor_graph
    from gnnome_tpu_torch.train.step import (make_example, make_optimizer,
                                             train_step)

    done = {}

    def forward(name, mid):
        cfg = _cfg(mid=mid)
        params, state = (inputs["weights"] if mid is None
                         else inputs["sharded_weights"][mid])
        src, dst, n, x, e = inputs["graphs"][name]
        model = load_model(params, state, cfg, cuda)
        args = (DeviceGraph.build(src, dst, n, cuda),
                torch.as_tensor(x, device=cuda),
                torch.as_tensor(e, device=cuda))
        gp = processor_graph(cfg.model, src, dst, n, cuda)
        with torch.inference_mode():
            return model(*args + (() if gp is None else (gp,)))[:, 0].cpu(
            ).numpy()

    def step(name, dtype):
        cfg = _cfg(dtype)
        unit = inputs["units"][name]
        model = load_model(*inputs["weights"], cfg, cuda)
        ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                          unit.src, unit.dst, unit.n_nodes, cuda)
        opt = make_optimizer(model, cfg.train.lr)
        loss, lo = train_step(model, opt, ex, 1.0, cfg, None)
        sd = {k: v.cpu() for k, v in model.state_dict().items()}
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        return {"loss": float(loss),
                "logits": lo.cpu().numpy()[ex.g.slot_of_eid.cpu().numpy()],
                "grads": numpy_from_module_state({**sd, **grads})[0],
                "state": numpy_from_module_state(sd)[1]}

    def get(kind, *key):
        if (kind, *key) not in done:
            done[kind, *key] = (forward if kind == "eval" else step)(*key)
        return done[kind, *key]

    return get


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _logits_close(got, ref, atol: float = LOGIT_ATOL) -> None:
    assert got is not None and got.shape == ref.shape
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    assert (d <= atol + LOGIT_RTOL * np.abs(ref)).all(), d.max()


def _launches_per_rank(res, want: dict) -> None:
    """Each rank launches ``want``, or nothing where its block (its
    processor graph's, for the zoo) holds no edge."""
    for r in res:
        p = r.get("proc") or r
        assert r["launches"] == (expected_launches(**want) if p["n_edges"]
                                 else expected_launches()), r["rank"]


# ----------------------------------------------------------------- halo
@pytest.mark.parametrize("P,name", [
    (2, "bench"), (4, "bench"), (2, "big"), (4, "big"), (2, "golden"),
    (4, "few"), *[(2, name) for name in SYNTH_GRAPHS]])
def test_halo_eval_vs_single_device(groups, single, inputs, P, name):
    """The halo eval forward's logits against the single-device card
    forward; 8 K3 + 1 K6 per rank (none on an empty block); the golden
    graph through the overflow-uncapped route, its AP within 1e-4 of the
    JAX figure; at P = 4 the 3-pair graph leaves one rank's block empty."""
    from gnnome_tpu_torch.train.metrics import get_aps

    res = groups(P)["eval", name]
    ref = single("eval", name, None)
    _logits_close(res[0]["logits"], ref,
                  SYNTH_LOGIT_ATOL if name in SYNTH_GRAPHS else LOGIT_ATOL)
    assert all(r["logits"] is None for r in res[1:])
    edges = [r["n_edges"] for r in res]
    assert sum(edges) == ref.shape[0]
    _launches_per_rank(res, FORWARD_LAUNCHES)
    if name == "golden":
        assert res[0]["route"] == "overflow-uncapped"
        ap = get_aps(res[0]["logits"], inputs["golden_y"])
        assert abs(ap - JAX_GOLDEN_AP) < AP_TOL, ap
    if name == "few":
        assert 0 in edges


@pytest.mark.parametrize("P,name,dtype", [
    (2, "bench", "float32"), (4, "bench", "float32"),
    (2, "bench", "bfloat16"), (2, "golden", "float32"),
    (4, "few", "float32")])
def test_halo_step_vs_single_device(groups, single, P, name, dtype):
    """One halo train step from the shipped weights against the
    single-device step: one loss on every rank, the parameters after Adam
    bitwise equal on every rank, the loss, gradients, BN running statistics
    (and, in float32, the logits) within the step bounds;
    16/16/16/16/2/2 K7/K3/K8/edge adjoint/K6/K9 per rank (in bf16 every
    one bf16; none on an empty block)."""
    res = groups(P)["step", name, dtype]
    ref = single("step", name, dtype)
    out = res[0]
    assert all(r["loss"] == out["loss"] for r in res)
    p0 = _leaves(out["params"])
    for r in res[1:]:
        pr = _leaves(r["params"])
        assert all(np.array_equal(pr[k], p0[k]) for k in p0), r["rank"]
    _launches_per_rank(res, HALO_STEP_LAUNCHES)
    bf16 = dtype == "bfloat16"
    if bf16:
        assert all(r["launches_bf16"] == r["launches"] for r in res)
    check_step({**out, "grads": _leaves(out["grads"]),
                "state": _leaves(out["state"])},
               {**ref, "grads": _leaves(ref["grads"]),
                "state": _leaves(ref["state"])}, bf16, logits=not bf16)
    if name == "few":
        edges = [r["n_edges"] for r in res]
        assert 0 in edges
        assert edges == [r["n_edges"] for r in groups(P)["eval", "few"]]


@pytest.mark.parametrize("P", [2, 4])
def test_wire_counts_equal_the_projection(groups, inputs, P):
    """Every rank's bytes and calls of the bench graph's eval forward (with
    the logits' gather) and train step equal the wire-cost model's
    (``parallel/projection.py``), as on gloo CPU ranks
    (tests/test_torch_projection.py::test_counts_equal_the_groups)."""
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.models import get_model
    from gnnome_tpu_torch.parallel.halo import plan_graph

    runs = groups(P)
    src, dst, n, _, _ = inputs["graphs"]["bench"]
    plan, _ = plan_graph(src, dst, n, P)
    cfg = Config()
    d, L = cfg.model.dim_latent, cfg.model.num_gnn_layers
    n_params = sum(p.numel() for p in get_model(cfg.model).parameters())
    check_wire_counts(runs["eval", "bench"], plan, "forward", d, L)
    check_wire_counts(runs["step", "bench", "float32"], plan, "step", d, L,
                      n_params)


def test_two_launchers_match_spawn_on_card(groups):
    """Two ``torch.distributed.run`` launchers of one rank each (127.0.0.1,
    a free port, the card shared over gloo) run
    scripts/torch_multihost_smoke.py's step on ``random_bench_graph(16,384,
    6.0)``: the loss bit for bit that of the same step on ``spawn``'s two
    ranks, and the same launches per rank (the recipe of
    tests/test_torch_multihost.py)."""
    ref = groups(2)["multihost",]
    found = launch_two_hosts(MULTIHOST_NODES, 1, "cuda")
    assert sorted(found) == [0, 1], found
    assert all(m[1] == "2" and m[2] == "0" for m in found.values())
    assert [found[r][4] for r in (0, 1)] == [repr(r["loss"]) for r in ref]
    launches = [json.loads(found[r][5]) for r in (0, 1)]
    assert launches == [r["launches"] for r in ref]
    assert all(c == expected_launches(**HALO_STEP_LAUNCHES)
               for c in launches)


# --------------------------------------------------------------- sharded
@pytest.mark.parametrize("P,name,mid", [
    *[(2, "golden", mid) for mid in SHARDED_MODELS],
    (2, "sharded_bench", "layer"), (4, "few", "layer"), (4, "few", "gcn")])
def test_sharded_eval_vs_single_device(groups, single, P, name, mid):
    """The sharded eval forward's logits (rank 0) against the single-device
    card forward; per rank 8 K1 + 8 K2 (layer norm, none) or the zoo
    model's one-sided walks, none where its shard holds no edge."""
    res = groups(P)["sharded", name, mid]
    ref = single("eval", name, mid)
    _logits_close(res[0]["logits"], ref)
    assert all(r["logits"] is None for r in res[1:])
    edges = [r["n_edges"] for r in res]
    assert sum(edges) == ref.shape[0]
    model = SHARDED_MODELS[mid][0]
    _launches_per_rank(res, K1K2_FORWARD_LAUNCHES if model == "sym_gatedgcn"
                       else {"k2_side_sum": ZOO_FORWARD_SIDE_SUMS[model]})
    if name == "few":
        assert 0 in edges


# ------------------------------------------------------- cli, mesh = 2
def test_cli_infer_mesh2_on_card(cuda, tmp_path):
    """``cli infer --set compute.mesh=2`` (the halo path, shipped weights)
    writes the single-device run's contigs; 8 K3 + 1 K6 per rank."""
    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.utils.fastx import read_fastx

    ds, _ = make_infer_dataset(str(tmp_path / "ds"))
    contigs = {}
    for name, extra in (("one", []), ("mesh", ["--set", "compute.mesh=2"])):
        out = str(tmp_path / name)
        summary = cli.main(["infer", "--data", ds, "--asm", "hifiasm",
                            "--out", out, "--model", WEIGHTS, "--set",
                            f"decode.len_threshold={INFER_LEN_THRESHOLD}",
                            *extra])
        contigs[name] = [r.seq for r in read_fastx(
            os.path.join(out, "assembly", "0_assembly.fasta"))]
    assert contigs["mesh"] == contigs["one"] and contigs["one"]
    assert summary["ranks"] == 2
    assert summary["rank_launches"] == [
        expected_launches(**FORWARD_LAUNCHES)] * 2


def test_cli_train_mesh2_on_card(cuda, tmp_path):
    """``cli train --set compute.mesh=2`` logs the single-device epoch's
    losses within 1e-4 relative, writes one checkpoint and one log, and
    every rank runs 16 K7, 16 K8 and 16 edge adjoints per training unit
    and validates with K3 and K6."""
    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph

    g, reads, _, _ = synthetic_assembly_graph(**OVERFIT_GRAPH)
    small = write_dataset(str(tmp_path / "small"), g, reads)
    logs = {}
    for name, extra in (("one", []), ("mesh", ["--set", "compute.mesh=2"])):
        ck = tmp_path / f"ckpt_{name}"
        cli.main(["train", "--train", small, "--valid", small, "--asm",
                  "hifiasm", "--name", name, "--set", "train.num_epochs=1",
                  "--set", "model.dropout=0",
                  "--set", f"paths.checkpoints_path={ck}",
                  "--set", f"paths.models_path={tmp_path}/models_{name}",
                  *extra])
        with open(ck / f"log_{name}_seed1.jsonl") as f:
            logs[name] = [json.loads(line) for line in f]
        assert sorted(os.listdir(ck)) == [f"ckpt_{name}_seed1.npz",
                                          f"log_{name}_seed1.jsonl"]
    (one,), (mesh,) = logs["one"], logs["mesh"]
    for k in ("train/loss", "valid/loss"):
        assert abs(mesh[k] - one[k]) <= HALO_TRAIN_LOSS_RTOL * abs(one[k])
    launches = mesh["halo_launches"]
    units = launches[0]["k9_aggregate"] // 2
    assert units >= 1 and len(launches) == 2
    for c in launches:
        assert (c["k7_gate_stats"] == 16 * units == c["k8_train_layer_bwd"]
                == c["bn_edge_adjoint"])
        assert c["k3_edge_stage"] > 16 * units and c["k6_score_gate"] > (
            2 * units)


def test_cli_infer_mesh2_sharded_on_card(cuda, tmp_path):
    """``cli infer --set compute.mesh=2`` with a layer-norm model (the
    overfit run's) writes the single-device FASTA byte for byte, 8 K1 +
    8 K2 per rank (the sharded layer runs the PyTorch chain between
    them)."""
    from gnnome_tpu_torch import cli

    best, _ = overfit_run(str(tmp_path / "train"), "layer")
    ds, _ = make_infer_dataset(str(tmp_path / "ds"))
    fasta = {}
    for name, extra in (("one", []), ("mesh", ["--set", "compute.mesh=2"])):
        out = tmp_path / name
        summary = cli.main(["infer", "--data", ds, "--asm", "hifiasm",
                            "--out", str(out), "--model", best,
                            "--set",
                            f"decode.len_threshold={INFER_LEN_THRESHOLD}",
                            "--set", "model.normalization=layer", *extra])
        fasta[name] = (out / "assembly" / "0_assembly.fasta").read_bytes()
    assert fasta["one"] and fasta["mesh"] == fasta["one"]
    assert summary["ranks"] == 2
    assert summary["rank_launches"] == [
        expected_launches(**K1K2_FORWARD_LAUNCHES)] * 2


# The entry points (gnnome_tpu_torch/entry.py) on the card: entry()'s
# logits against entry(device="cpu") within the forward tolerance of
# tests/test_torch_train.py:62, a second card call bitwise equal, 8 K3 + 1
# K6 launches, none bf16; a 2-rank dry run (gloo ranks sharing the card,
# or NCCL with two GPUs) with 16/16/16/16/2/2 K7/K3/K8/edge adjoint/K6/K9
# launches per rank, none bf16.
def test_entry_on_card_vs_cpu(cuda):
    from gnnome_tpu_torch.entry import entry

    fn_cpu, args_cpu = entry("cpu")
    ref = fn_cpu(*args_cpu).numpy()
    fn, args = entry("cuda")
    K.reset_launch_counts()
    a = fn(*args)
    counts = K.launch_counts(), K.launch_counts(torch.bfloat16)
    b = fn(*args)
    np.testing.assert_allclose(a.cpu().numpy(), ref, atol=5e-5, rtol=1e-4)
    assert np.isfinite(ref).all()
    assert torch.equal(a, b)
    assert counts == (expected_launches(**FORWARD_LAUNCHES),
                      expected_launches())


def test_dryrun_two_ranks_on_card(cuda):
    from gnnome_tpu_torch.entry import dryrun_multichip

    res = dryrun_multichip(2, "cuda")
    assert np.isfinite(res["loss"])
    want = expected_launches(**HALO_STEP_LAUNCHES)
    assert res["launches_per_rank"] == [want, want]
    assert res["launches_bf16_per_rank"] == [expected_launches()] * 2
