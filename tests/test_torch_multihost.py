"""gnnome_tpu_torch across hosts (``parallel/group.py`` ``join`` / ``run``,
the counterpart of ``jax.distributed.initialize()``): ranks that a
launcher per host started (``python -m torch.distributed.run``) join one
group and run the halo train step unchanged.

* Two launchers x 2 ranks over gloo on the CPU (scripts/
  torch_multihost_smoke.py, 4,096 nodes): one loss on every rank, bitwise
  that of ``spawn`` with 4 ranks on the same unit; at the JAX script's
  16,384 nodes too (``slow``, as tests/test_multihost.py is).
* Where the hosts' disks differ, rank 0 decides: ``infer`` with a logits
  cache in rank 0's directory alone scores nothing (no rank loads the
  model, which does not exist); ``train --resume`` with the checkpoint in
  rank 0's directory alone resumes bitwise as the uninterrupted run; a run
  without a name takes rank 0's.  Each rank has its own paths, as each
  host's launcher passes its own command line (``checks.per_rank_job``).
* Refusals: ``compute.mesh`` other than ``WORLD_SIZE``, a launcher's
  environment without its address, CUDA without a GPU.

Each multi-process test bounds itself (``spawn``'s ``deadline_s``,
``communicate(timeout=...)``); a launcher whose port was taken is retried
once on another.
"""
import os

import numpy as np
import pytest
import torch

from gnnome_tpu_torch.config import Config
from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.infer import run_inference, score_graph
from gnnome_tpu_torch.parallel import checks
from gnnome_tpu_torch.parallel.group import (check_launch, join, launched,
                                             spawn)
from gnnome_tpu_torch.train.loop import train
from torch_recipes import LAUNCH_ENV, launch_two_hosts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "weights.npz")


def _two_hosts_match_spawn(n_nodes: int) -> None:
    found = launch_two_hosts(n_nodes, 2, "cpu")
    assert sorted(found) == [0, 1, 2, 3], found
    assert all(m[1] == "4" and m[3] == "gloo" for m in found.values())
    # global rank = host index x local ranks + local rank
    assert [int(found[r][2]) for r in range(4)] == [0, 1, 0, 1]
    losses = {m[4] for m in found.values()}
    assert len(losses) == 1
    unit, params, state, cfg = checks.multihost_inputs(n_nodes, 4, "cpu")
    res = spawn(checks.train_step_job, 4, unit, params, state, cfg, 1.0,
                deadline_s=300)
    assert losses == {repr(r["loss"]) for r in res}
    assert 0.0 < float(losses.pop()) < 100.0


def test_two_launchers_match_spawn():
    _two_hosts_match_spawn(4096)


@pytest.mark.slow
def test_two_launchers_match_spawn_at_the_jax_size():
    _two_hosts_match_spawn(16_384)


# ------------------------------------------------ rank 0's decisions
TINY = dict(num_gnn_layers=3, dim_latent=16, hidden_edge_scores=16)


def _cfg(**paths) -> Config:
    cfg = Config()
    cfg.compute.device = "cpu"
    cfg.compute.mesh = 2
    cfg.decode.len_threshold = 5000
    for k, v in TINY.items():
        setattr(cfg.model, k, v)
    for k, v in paths.items():
        setattr(cfg.paths, k, str(v))
    return cfg


@pytest.fixture(scope="module")
def per_host(tmp_path_factory):
    """One group of 2 CPU ranks, each with its own directories, runs:
    ``infer`` with a logits cache in rank 0's save directory alone and a
    model path that does not exist; ``train`` one epoch (name ``t``), then
    ``--resume`` to 2 with the checkpoint in rank 0's directory alone, an
    uninterrupted 2-epoch run (``u``) and a run without a name."""
    root = tmp_path_factory.mktemp("per_host")
    ds = root / "ds"
    for sub in ("processed", "info"):
        (ds / "hifiasm" / sub).mkdir(parents=True)
    g, reads, _, _ = synthetic_assembly_graph(
        n_reads=300, genome_len=25000, read_len=400, seed=13,
        with_sequences=True)
    g.save(str(ds / "hifiasm" / "processed" / "0.npz"))
    reads.save(str(ds / "hifiasm" / "info" / "0_reads.npz"))
    cached = np.where(g.y > 0.5, 5.0, -5.0).astype(np.float32)
    (root / "host0" / "decode").mkdir(parents=True)
    np.save(root / "host0" / "decode" / "0_predicts.npy", cached)
    missing = str(root / "no_such_model.npz")

    def infer_args(host):
        return (str(ds), missing, "hifiasm", str(root / host), _cfg(), False)

    def train_args(host, name, epochs, resume):
        cfg = _cfg(checkpoints_path=root / host / "ckpt",
                   models_path=root / host / "models")
        cfg.train.num_epochs = epochs
        return (str(ds), str(ds), "hifiasm", name, False, resume, cfg)

    hosts = ("host0", "host1")
    jobs = [(checks.per_rank_job, (run_inference,
                                   [infer_args(h) for h in hosts])),
            (checks.per_rank_job, (train, [train_args(h, "t", 1, False)
                                           for h in hosts])),
            (checks.per_rank_job, (train, [train_args(h, "t", 2, True)
                                           for h in hosts])),
            (checks.per_rank_job, (train, [train_args(h, "u", 2, False)
                                           for h in hosts])),
            (checks.per_rank_job, (train, [train_args(h, None, 1, False)
                                           for h in hosts]))]
    res = spawn(checks.run_jobs, 2, jobs, deadline_s=300)
    # the same cached scores decoded on one device
    one = _cfg()
    one.compute.mesh = 0
    (root / "one" / "decode").mkdir(parents=True)
    np.save(root / "one" / "decode" / "0_predicts.npy", cached)
    single = run_inference(str(ds), missing, "hifiasm", str(root / "one"),
                           one, verbose=False)
    return root, res, single


def test_infer_takes_rank0_logits_cache(per_host):
    root, res, single = per_host
    summary, other = res[0][0], res[1][0]
    assert other is None and summary["ranks"] == 2
    fasta = "assembly/0_assembly.fasta"
    with open(root / "host0" / fasta) as a, open(root / "one" / fasta) as b:
        assert a.read() == b.read()
    assert not (root / "host1" / "decode" / "0_predicts.npy").exists()
    assert summary["graphs"][0]["num_contigs"] == \
        single["graphs"][0]["num_contigs"]


def test_resume_reads_rank0_checkpoint(per_host):
    root, res, _ = per_host
    ck = root / "host0" / "ckpt"
    assert not (root / "host1" / "ckpt" / "ckpt_t_seed1.npz").exists()
    with np.load(ck / "ckpt_t_seed1_resumed-2.npz") as a, \
            np.load(ck / "ckpt_u_seed1.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def test_run_name_is_rank0s(per_host):
    root, res, _ = per_host
    paths = [r[4] for r in res]
    names = {os.path.basename(p) for p in paths}
    assert len(names) == 1
    assert os.path.isfile(paths[0])
    assert sorted(os.listdir(root / "host1" / "models")) == []


# --------------------------------------------------------------- refusals
def test_mesh_other_than_world_size_is_refused(monkeypatch, tmp_path):
    for k, v in LAUNCH_ENV.items():
        monkeypatch.setenv(k, v)
    assert launched().size == 2
    for mesh in (0, 1, 3):
        with pytest.raises(ValueError, match="WORLD_SIZE=2"):
            check_launch(mesh)
    cfg = _cfg(checkpoints_path=tmp_path, models_path=tmp_path)
    cfg.compute.mesh = 3
    with pytest.raises(ValueError, match="compute.mesh=3.*WORLD_SIZE=2"):
        run_inference(str(tmp_path), WEIGHTS, "hifiasm", str(tmp_path), cfg)
    cfg.compute.mesh = 0
    with pytest.raises(ValueError, match="compute.mesh=0.*WORLD_SIZE=2"):
        train(str(tmp_path), str(tmp_path), "hifiasm", "x", cfg=cfg)
    with pytest.raises(ValueError, match="WORLD_SIZE=2"):
        score_graph(None, {}, {}, cfg)


def test_launcher_environment_must_be_whole(monkeypatch):
    for k, v in LAUNCH_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MASTER_ADDR")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        launched()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a GPU: the refusal it checks")
def test_launched_cuda_without_gpu_raises(monkeypatch):
    for k, v in LAUNCH_ENV.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        join("cuda")
