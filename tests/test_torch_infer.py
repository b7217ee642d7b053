"""gnnome_tpu_torch ``infer`` end to end on the CPU: CLI, logits cache,
decode, FASTA; decode parity with the JAX package on the same scores; and no
silent CPU fallback when the GPU is asked for and absent."""
import filecmp
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from gnnome_tpu import cli as jax_cli

from gnnome_tpu_torch import cli
from gnnome_tpu_torch.config import Config
from gnnome_tpu_torch.data.dataset import dataset_for
from gnnome_tpu_torch.graphs.synthetic import (random_genome,
                                               simulate_reads_from_genome,
                                               write_synthetic_gfa)
from gnnome_tpu_torch.infer import run_inference, score_graph
from gnnome_tpu_torch.models import load_model_weights
from gnnome_tpu_torch.utils.fastx import read_fastx, reverse_complement

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "weights.npz")
CPU = ["--set", "compute.device=cpu"]


@pytest.fixture(scope="module")
def e2e_dataset(tmp_path_factory):
    """The synthetic dataset of tests/test_e2e.py:16-27, built into the
    dataset layout by the port's ``build-graph``."""
    root = tmp_path_factory.mktemp("torch_e2e")
    rng = np.random.default_rng(11)
    genome = random_genome(30_000, rng)
    records, starts, ends, strands = simulate_reads_from_genome(
        genome, 300, 700, rng)
    gfa, reads = str(root / "g.gfa"), str(root / "reads.fasta")
    write_synthetic_gfa(records, starts, ends, strands, gfa, reads,
                        dialect="hifiasm")
    ds = str(root / "ds")
    cli.main(["build-graph", "--gfa", gfa, "--reads", reads,
              "--asm", "hifiasm", "--out", ds, "--threads", "2"])
    return ds


def _infer(ds, savedir, model=WEIGHTS, extra=()):
    return cli.main(["infer", "--data", ds, "--asm", "hifiasm",
                     "--out", savedir, "--model", model, *CPU,
                     "--set", "decode.len_threshold=3000",
                     "--set", "decode.num_decoding_paths=20", *extra])


def test_cli_infer_cpu_writes_fasta_and_logits_cache(e2e_dataset, tmp_path):
    savedir = str(tmp_path / "out")
    summary = _infer(e2e_dataset, savedir)
    asm = os.path.join(savedir, "assembly", "0_assembly.fasta")
    cache = os.path.join(savedir, "decode", "0_predicts.npy")
    assert os.path.isfile(asm) and os.path.isfile(cache)
    assert summary["device"] == "cpu"
    assert set(summary["timing"]) == {"score", "decode", "assemble"}
    assert summary["peak_rss_mb"] > 0
    contigs = list(read_fastx(asm))
    assert max(len(c.seq) for c in contigs) >= 3000
    # the second run scores nothing: the cache is read, the model never loaded
    os.remove(asm)
    _infer(e2e_dataset, savedir, model=str(tmp_path / "no_such_model.npz"))
    assert os.path.isfile(asm)


def test_decode_matches_jax_package_on_same_scores(e2e_dataset, tmp_path):
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _infer(e2e_dataset, port_dir)
    os.makedirs(os.path.join(jax_dir, "decode"))
    shutil.copy(os.path.join(port_dir, "decode", "0_predicts.npy"),
                os.path.join(jax_dir, "decode", "0_predicts.npy"))
    jax_cli.main(["infer", "--data", e2e_dataset, "--asm", "hifiasm",
                  "--out", jax_dir, "--model", WEIGHTS, *CPU,
                  "--set", "decode.len_threshold=3000",
                  "--set", "decode.num_decoding_paths=20"])
    assert filecmp.cmp(os.path.join(port_dir, "assembly", "0_assembly.fasta"),
                       os.path.join(jax_dir, "assembly", "0_assembly.fasta"),
                       shallow=False)


def test_chip_smoke_dataset_decodes_exact_contig_on_cpu(tmp_path):
    """The dataset ``chip_smoke.py`` decodes on the card, here on the CPU:
    one long contig that is an exact substring of the genome."""
    sys.path.insert(0, ROOT)
    try:
        from chip_smoke import INFER_GRAPH, make_infer_dataset
    finally:
        sys.path.remove(ROOT)
    ds, genome = make_infer_dataset(str(tmp_path / "ds"))
    savedir = os.path.join(ds, "hifiasm")
    cli.main(["infer", "--data", ds, "--asm", "hifiasm", "--out", savedir,
              "--model", WEIGHTS, *CPU,
              "--set", "decode.len_threshold=5000"])
    contigs = list(read_fastx(os.path.join(savedir, "assembly",
                                           "0_assembly.fasta")))
    top = max(contigs, key=lambda c: len(c.seq))
    assert len(top.seq) >= 5000
    assert top.seq in genome or top.seq in reverse_complement(genome)
    g = dataset_for("hifiasm", ds).load_graph(0)
    assert g.num_nodes == 2 * INFER_GRAPH["n_reads"]


def test_no_silent_cpu_fallback(e2e_dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = dataset_for("hifiasm", e2e_dataset).load_graph(0)
    params, state = load_model_weights(WEIGHTS)
    with pytest.raises(RuntimeError, match="compute.device=cpu"):
        score_graph(g, params, state)              # default: compute.device=cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_inference(e2e_dataset, WEIGHTS, "hifiasm", str(tmp_path), Config())


def test_jax_only_compute_options_are_rejected():
    for key in ("backend=pallas", "bucket_growth=1.5", "remat=full"):
        with pytest.raises(AttributeError, match="gnnome_tpu_torch does not"):
            Config().apply_overrides([f"compute.{key}"])
    cfg = Config().apply_overrides(["compute.device=cpu",
                                    "decode.len_threshold=5000"])
    assert (cfg.compute.device, cfg.decode.len_threshold) == ("cpu", 5000)


def test_decode_keeps_a_checkpoint_it_did_not_use(tmp_path):
    """With ``load_checkpoint=False`` a decode neither reads nor writes (short
    decode: fewer than 10 contigs) an existing checkpoint, so it must leave
    it in place.  The JAX package's decode (the behaviour the port's copy
    had) deletes it; the port keeps it, and still deletes one it read."""
    from gnnome_tpu.config import DecodeConfig as JaxDecodeConfig
    from gnnome_tpu.decode.greedy import decode_greedy as jax_decode

    from gnnome_tpu_torch.config import DecodeConfig
    from gnnome_tpu_torch.decode import decode_greedy
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph

    g, _, _, _ = synthetic_assembly_graph(n_reads=120, genome_len=10000,
                                          read_len=400, seed=12)
    scores = np.where(g.y > 0.5, 5.0, -5.0).astype(np.float32)
    ckpt = tmp_path / "checkpoint.pkl"
    foreign = b"another run's decode checkpoint"

    def decode(fn, cfg):
        ckpt.write_bytes(foreign)
        cfg.load_checkpoint = False
        cfg.len_threshold = 1000
        out = fn(g, scores, cfg, checkpoint_dir=str(tmp_path),
                 rng=np.random.default_rng(0))
        assert 0 < len(out.walks) < 10
        return ckpt.exists()

    assert not decode(jax_decode, JaxDecodeConfig())       # the old fault
    assert decode(decode_greedy, DecodeConfig())            # fixed
    assert ckpt.read_bytes() == foreign
    # a checkpoint this run read is this run's: removed once complete
    import pickle
    ckpt.write_bytes(pickle.dumps({"walks": [], "visited": np.zeros(0, int),
                                   "all_walks_len": [],
                                   "all_contigs_len": []}))
    cfg = DecodeConfig()
    cfg.len_threshold = 1000
    decode_greedy(g, scores, cfg, checkpoint_dir=str(tmp_path),
                  rng=np.random.default_rng(0))
    assert not ckpt.exists()
