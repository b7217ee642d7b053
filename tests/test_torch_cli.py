"""gnnome_tpu_torch's CLI subcommands besides ``infer`` and ``train``, on
the CPU, against the JAX package's CLI where it has a counterpart.

* ``build-graph``: the synthetic hifiasm and raven GFAs and every GFA
  fixture, with and without ``--training``: every array of both npz files,
  the aux pickle and the Graphia file equal to what ``gnnome_tpu.cli
  build-graph`` writes.
* ``run`` with a stub ``hifiasm`` (a script that copies a prepared GFA to
  ``<-o>.bp.raw.r_utg.gfa``): the FASTA of ``build-graph`` + ``infer``.
* ``generate-data`` with the fake PBSIM of tests/test_simulate.py and a
  stub ``hifiasm`` that writes a GFA over the reads it is given: raw FASTA
  byte for byte and processed arrays equal to the JAX run's.
* ``split-data`` (with a chromosome JSON): the same directory trees, byte
  for byte, as the JAX package's from the same data.
* ``evaluate``: the same stdout.  ``convert-weights``: the ``.pt`` equal to
  JAX ``pytree_to_torch`` tensor for tensor, the npz back equal to the
  source.  ``install-tools`` with every tool present: only "Found" lines,
  nothing run.  ``download-profile`` without the PBSIM3 directory: the JAX
  package's ``FileNotFoundError``, naming this package's command.

The external tools are stubs written here; nothing reaches the network.
"""
import importlib.util
import json
import os
import pickle
import stat

import numpy as np
import pytest
import torch

from gnnome_tpu import cli as jax_cli
from gnnome_tpu.models.checkpoint import load_model_weights as jax_weights
from gnnome_tpu.models.convert import pytree_to_torch

from gnnome_tpu_torch import cli
from gnnome_tpu_torch.graphs.synthetic import (random_genome,
                                               simulate_reads_from_genome,
                                               write_synthetic_gfa)
from gnnome_tpu_torch.utils.fastx import (FastxRecord, read_fastx,
                                          reverse_complement, write_fasta)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
WEIGHTS = os.path.join(ROOT, "weights", "weights.npz")
CPU = ["--set", "compute.device=cpu"]
DECODE = ["--set", "decode.len_threshold=3000",
          "--set", "decode.num_decoding_paths=20"]

STUB_HIFIASM_COPY = """#!/bin/sh
# stub hifiasm: writes the prepared GFA as <-o prefix>.bp.raw.r_utg.gfa
out=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift 2;; *) shift;; esac
done
cp "{gfa}" "$out.bp.raw.r_utg.gfa"
"""

STUB_HIFIASM_LAYOUT = r'''#!/usr/bin/env python3
"""stub hifiasm: a raven-dialect GFA over the reads it is given, one S
record per read and an L record for each pair that overlaps on the genome
(positions from the reads' strand=/start=/end= headers)."""
import sys

args = sys.argv[1:]
prefix, reads = args[args.index("-o") + 1], args[-1]
recs, rid, seq = [], None, []
for line in open(reads):
    line = line.strip()
    if line.startswith(">"):
        if rid is not None:
            recs.append((rid, desc, "".join(seq)))
        rid, desc, seq = line[1:].split()[0], line[1:], []
    else:
        seq.append(line)
recs.append((rid, desc, "".join(seq)))
info = []
for rid, desc, s in recs:
    kv = dict(f.split("=") for f in desc.split()[1:] if "=" in f)
    info.append((int(kv["start"]), int(kv["end"]), kv["strand"], rid, s))
info.sort()
with open(prefix + ".bp.raw.r_utg.gfa", "w") as f:
    for _, _, _, rid, s in info:
        f.write(f"S\t{rid}\t{s}\tLN:i:{len(s)}\n")
    for (sa, ea, oa, ia, _), (sb, eb, ob, ib, _) in zip(info, info[1:]):
        if sb < ea:
            f.write(f"L\t{ia}\t{oa}\t{ib}\t{ob}\t{ea - sb}M\n")
'''


def _exe(path, text):
    with open(path, "w") as f:
        f.write(text)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


def _synthetic_gfa(root, dialect, n_reads=200, genome_len=20_000, seed=11):
    """A synthetic genome's reads as a GFA of ``dialect`` + FASTA."""
    rng = np.random.default_rng(seed)
    genome = random_genome(genome_len, rng)
    records, starts, ends, strands = simulate_reads_from_genome(
        genome, n_reads, 700, rng)
    gfa, reads = str(root / f"{dialect}.gfa"), str(root / f"{dialect}.fasta")
    write_synthetic_gfa(records, starts, ends, strands, gfa, reads,
                        dialect=dialect)
    return gfa, reads, genome


# ---------------------------------------------------------- dataset trees
def _tree(root):
    """Relative path -> bytes of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _assert_npz_equal(a, b):
    with np.load(a, allow_pickle=False) as x, np.load(b,
                                                      allow_pickle=False) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def assert_same_dataset(port_root, jax_root, asm):
    """Every file of the port's dataset against the JAX package's: npz
    arrays, pickles by value, anything else byte for byte."""
    a, b = os.path.join(port_root, asm), os.path.join(jax_root, asm)
    files = sorted(_tree(b))
    assert sorted(_tree(a)) == files and files
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npz"):
            _assert_npz_equal(pa, pb)
        elif rel.endswith(".pkl"):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert pickle.load(fa) == pickle.load(fb), rel
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_gfa")
    return {d: _synthetic_gfa(root, d) for d in ("hifiasm", "raven")}


def _build_both(tmp_path, gfa, reads, asm, training):
    extra = ["--training"] if training else []
    roots = []
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        out = str(tmp_path / name)
        main(["build-graph", "--gfa", gfa, "--reads", reads, "--asm", asm,
              "--out", out, "--threads", "2", *extra])
        roots.append(out)
    return roots


@pytest.mark.parametrize("training", [False, True],
                         ids=["plain", "training"])
@pytest.mark.parametrize("dialect", ["hifiasm", "raven"])
def test_build_graph_synthetic_matches_jax(synthetic, tmp_path, dialect,
                                           training):
    gfa, reads, _ = synthetic[dialect]
    port, jax = _build_both(tmp_path, gfa, reads, dialect, training)
    assert_same_dataset(port, jax, dialect)
    g = np.load(os.path.join(port, dialect, "processed", "0.npz"))
    assert ("y" in g.files) == training and "overlap_similarity" in g.files


FIXTURE_BUILDS = [
    ("hifiasm_bp_raw_r_utg.gfa", "hifi_reads.fasta", "hifiasm", True),
    ("hifiasm_8col_r_utg.gfa", "hifi_reads.fasta", "hifiasm", True),
    ("hifiasm_multichr_r_utg.gfa", "hifi_reads_multichr.fasta.gz",
     "hifiasm", True),
    ("hifiasm_circular_utg.gfa", "hifi_reads.fasta", "hifiasm", False),
    ("raven_graph_1.gfa", "ont_reads.fasta", "raven", True),
    ("raven_graph_1_noseq.gfa", "ont_reads.fasta", "raven", True),
]


@pytest.mark.parametrize("gfa,reads,asm,training", [
    (g, r, a, t) for g, r, a, trains in FIXTURE_BUILDS
    for t in ((False, True) if trains else (False,))])
def test_build_graph_fixture_matches_jax(tmp_path, gfa, reads, asm,
                                         training):
    port, jax = _build_both(tmp_path, os.path.join(FIX, gfa),
                            os.path.join(FIX, reads), asm, training)
    assert_same_dataset(port, jax, asm)


def test_build_graph_refuses_missing_inputs(tmp_path):
    with pytest.raises(AssertionError, match="GFA not found"):
        cli.main(["build-graph", "--gfa", str(tmp_path / "no.gfa"),
                  "--reads", str(tmp_path / "no.fa"), "--asm", "hifiasm",
                  "--out", str(tmp_path / "ds")])


# --------------------------------------------------------------------- run
def test_run_with_stub_hifiasm_writes_the_build_graph_infer_fasta(
        synthetic, tmp_path):
    """``run`` = stub hifiasm, ``build-graph``, ``infer`` (on the CPU): the
    FASTA of the two-step route, byte for byte, and an exact contig."""
    gfa, reads, genome = synthetic["hifiasm"]
    tools = tmp_path / "hifiasm_dir"
    tools.mkdir()
    _exe(str(tools / "hifiasm"), STUB_HIFIASM_COPY.format(gfa=gfa))
    out = str(tmp_path / "run")
    summary = cli.main(["run", "-r", reads, "-o", out, "-t", "2",
                        "-m", WEIGHTS, "--set", f"paths.hifiasm_dir={tools}",
                        *CPU, *DECODE])
    assert summary["device"] == "cpu"
    ds = str(tmp_path / "two_step")
    cli.main(["build-graph", "--gfa", gfa, "--reads", reads, "--asm",
              "hifiasm", "--out", ds, "--threads", "2"])
    cli.main(["infer", "--data", ds, "--asm", "hifiasm", "--out",
              os.path.join(ds, "hifiasm"), "--model", WEIGHTS, *CPU,
              *DECODE])
    fasta = os.path.join("hifiasm", "assembly", "0_assembly.fasta")
    with open(os.path.join(out, fasta), "rb") as a, \
            open(os.path.join(ds, fasta), "rb") as b:
        got, want = a.read(), b.read()
    assert got == want and got
    top = max(read_fastx(os.path.join(out, fasta)), key=lambda r: len(r.seq))
    assert top.seq in genome or top.seq in reverse_complement(genome)


# ------------------------------------------------- generate-data, split-data
def _fake_pbsim():
    spec = importlib.util.spec_from_file_location(
        "_jax_test_simulate", os.path.join(ROOT, "tests", "test_simulate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAKE_PBSIM


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """``generate-data`` from both packages with the fake PBSIM and the
    layout stub ``hifiasm`` on 200-bp chromosomes 18, 19 and 20 (the
    default train/valid chromosomes)."""
    tmp = tmp_path_factory.mktemp("torch_cli_generate")
    pbsim = tmp / "pbsim3"
    (pbsim / "src").mkdir(parents=True)
    _exe(str(pbsim / "src" / "pbsim"), _fake_pbsim())
    (pbsim / "sample_profile_test.fastq").write_text("")
    tools = tmp / "hifiasm_dir"
    tools.mkdir()
    _exe(str(tools / "hifiasm"), STUB_HIFIASM_LAYOUT)
    chrs = tmp / "chrs"
    chrs.mkdir()
    rng = np.random.default_rng(0)
    for c in (18, 19, 20):
        genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 200))
        write_fasta([FastxRecord(f"chr{c}", f"chr{c}", genome)],
                    str(chrs / f"chr{c}.fasta"))
    sets = ["--set", f"paths.pbsim3_dir={pbsim}",
            "--set", "data.sample_profile_id=test",
            "--set", f"paths.hifiasm_dir={tools}"]
    out = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        datadir = str(tmp / name)
        main(["generate-data", "--datadir", datadir, "--chrdir", str(chrs),
              "--asm", "hifiasm", *sets])
        out[name] = datadir
    return tmp, out


def test_generate_data_matches_jax(generated):
    _, out = generated
    port, jax = out["port"], out["jax"]
    for chrN, n in (("chr18", 1), ("chr19", 1), ("chr20", 2)):
        for i in range(n):
            raw = os.path.join(chrN, "raw", f"{i}.fasta")
            with open(os.path.join(port, raw), "rb") as a, \
                    open(os.path.join(jax, raw), "rb") as b:
                assert a.read() == b.read(), raw
        assert_same_dataset(os.path.join(port, chrN), os.path.join(jax, chrN),
                            "hifiasm")
        g = np.load(os.path.join(port, chrN, "hifiasm", "processed",
                                 "0.npz"))
        assert g["src"].size > 0 and "y" in g.files


def test_split_data_matches_jax(generated, tmp_path):
    """Both packages split the port's generated data into the same trees;
    the chromosome counts come from a JSON file."""
    _, out = generated
    cfg = tmp_path / "chrs.json"
    cfg.write_text(json.dumps({"train": {"chr18_hg002": 1, "chr20_hg002": 1},
                               "valid": {"chr19_hg002": 1,
                                         "chr20_hg002": 1}}))
    trees = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        save = str(tmp_path / name)
        main(["split-data", "--datadir", out["port"], "--savedir", save,
              "--asm", "hifiasm", "--name", "t", "--chrs-config", str(cfg)])
        trees[name] = _tree(save)
    assert trees["port"] == trees["jax"]
    assert {"train_t/hifiasm/processed/0.npz",
            "train_t/hifiasm/processed/1.npz",
            "valid_t/hifiasm/processed/1.npz",
            "valid_t/hifiasm/info/g_to_chr.pkl"} <= set(trees["port"])


def test_chromosome_config_matches_jax(tmp_path):
    from gnnome_tpu.data import chromosomes as jax_chrs

    from gnnome_tpu_torch.data import chromosomes

    assert chromosomes.get_train_valid_chrs() == \
        jax_chrs.get_train_valid_chrs()
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"train": {"chr1_hg002": 3},
                             "valid": {"chr2_hg002": 1}}))
    assert chromosomes.get_train_valid_chrs(str(p)) == \
        jax_chrs.get_train_valid_chrs(str(p))
    d1, d2 = {"a": 1, "b": 2}, {"b": 3, "c": 4}
    assert chromosomes.merge_dicts(d1, d2) == jax_chrs.merge_dicts(d1, d2)


# ----------------------------------------------------------------- evaluate
@pytest.mark.parametrize("flags", [["--ref-length", "12000"],
                                   ["--chr", "chr19"], []],
                         ids=["ref_length", "chr19", "none"])
def test_evaluate_prints_what_jax_prints(tmp_path, capsys, flags):
    rng = np.random.default_rng(3)
    contigs = [FastxRecord(f"c{i}", f"c{i}", random_genome(int(n), rng))
               for i, n in enumerate(rng.integers(200, 5000, 7))]
    asm = str(tmp_path / "asm.fasta")
    write_fasta(contigs, asm)
    capsys.readouterr()
    ev = cli.main(["evaluate", "--assembly", asm, *flags])
    port = capsys.readouterr().out
    jax_cli.main(["evaluate", "--assembly", asm, *flags])
    assert port == capsys.readouterr().out and port
    assert ev["num_contigs"] == 7 and ("ng50" in ev) == bool(flags)


# ---------------------------------------------------------- convert-weights
def test_convert_weights_round_trip_matches_jax(tmp_path):
    pt, back = str(tmp_path / "w.pt"), str(tmp_path / "w.npz")
    cli.main(["convert-weights", WEIGHTS, pt])
    cli.main(["convert-weights", pt, back])
    got = torch.load(pt, map_location="cpu")
    want = pytree_to_torch(*jax_weights(WEIGHTS))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    _assert_npz_equal(back, WEIGHTS)


# ------------------------------------------- install-tools, download-profile
def test_install_tools_with_every_tool_present_runs_nothing(
        tmp_path, capsys, monkeypatch):
    from gnnome_tpu_torch.data import tools

    for rel in ("hifiasm/hifiasm", "raven/build/bin/raven",
                "pbsim3/src/pbsim"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("")

    def refuse(*a, **kw):
        raise AssertionError(f"install-tools ran {a!r}")

    monkeypatch.setattr(tools.subprocess, "run", refuse)
    sets = ["--set", f"paths.tool_dir={tmp_path}",
            "--set", f"paths.hifiasm_dir={tmp_path / 'hifiasm'}",
            "--set", f"paths.raven_dir={tmp_path / 'raven'}",
            "--set", f"paths.pbsim3_dir={tmp_path / 'pbsim3'}"]
    capsys.readouterr()
    cli.main(["install-tools", *sets])
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["Found hifiasm! Skipping installation...",
                     "Found raven! Skipping installation...",
                     "Found pbsim! Skipping installation..."]


def test_download_profile_without_pbsim3_fails_as_jax(tmp_path):
    sets = ["--set", f"paths.pbsim3_dir={tmp_path / 'no_pbsim3'}"]
    with pytest.raises(FileNotFoundError) as port:
        cli.main(["download-profile", *sets])
    with pytest.raises(FileNotFoundError) as ref:
        jax_cli.main(["download-profile", *sets])
    assert str(port.value) == str(ref.value).replace(
        "'gnnome-tpu install-tools'", "'gnnome-tpu-torch install-tools'")


def test_every_jax_subcommand_and_flag_is_there():
    """The port's parser has every subcommand of ``gnnome_tpu.cli`` with
    the same flags (the ``infer --profile`` help text aside)."""
    import argparse

    def surface(main):
        seen = {}

        def fake_parse(self, argv=None, namespace=None):
            sub = next(a for a in self._actions
                       if isinstance(a, argparse._SubParsersAction))
            for name, p in sub.choices.items():
                seen[name] = sorted(
                    (tuple(a.option_strings) or (a.dest,), a.required,
                     repr(a.default), a.nargs, a.type.__name__ if a.type
                     else None, tuple(a.choices or ()))
                    for a in p._actions)
            raise SystemExit(0)

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = fake_parse
        try:
            with pytest.raises(SystemExit):
                main(["--help"])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    port, ref = surface(cli.main), surface(jax_cli.main)
    assert list(port) == list(ref)
    assert port == ref


# ------------------------------------------------- the datasets' assemblers
STUB_RAVEN = """#!/bin/sh
# stub raven: writes the prepared GFA as graph_1.gfa in the working
# directory (raven -p0 does) and a one-contig FASTA on stdout
cp "{gfa}" graph_1.gfa
echo ">contig_0"
echo "ACGT"
"""


def test_raven_dataset_process_matches_jax(tmp_path):
    """``process()`` of the ONT dataset: raven (a stub) on ``raw/0.fasta``,
    then the training parse, in both packages."""
    from gnnome_tpu.config import Config as JaxConfig
    from gnnome_tpu.data.dataset import dataset_for as jax_dataset_for

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.data.dataset import dataset_for

    gfa, reads = os.path.join(FIX, "raven_graph_1.gfa"), os.path.join(
        FIX, "ont_reads.fasta")
    raven = tmp_path / "raven" / "build" / "bin"
    raven.mkdir(parents=True)
    _exe(str(raven / "raven"), STUB_RAVEN.format(gfa=gfa))
    roots = []
    for name, make, cfg in (("port", dataset_for, Config()),
                            ("jax", jax_dataset_for, JaxConfig())):
        cfg.paths.raven_dir = str(tmp_path / "raven")
        root = tmp_path / name
        (root / "raw").mkdir(parents=True)
        with open(reads, "rb") as src, open(root / "raw" / "0.fasta",
                                            "wb") as dst:
            dst.write(src.read())
        ds = make("raven", str(root), generate=True, n_need=1, config=cfg)
        assert len(ds) == 1
        roots.append(str(root))
    assert_same_dataset(*roots, "raven")
    with open(os.path.join(roots[0], "raven", "output",
                           "0_assembly.fasta")) as f:
        assert f.read() == ">contig_0\nACGT\n"


def test_plain_dataset_runs_no_assembler(tmp_path):
    from gnnome_tpu_torch.data.dataset import AssemblyGraphDataset

    (tmp_path / "raw").mkdir()
    (tmp_path / "raw" / "0.fasta").write_text(">r\nACGT\n")
    with pytest.raises(TypeError, match="dataset_for"):
        AssemblyGraphDataset(str(tmp_path), generate=True, n_need=1)


def test_hifiasm_contig_extraction_matches_jax(tmp_path):
    """hifiasm's own contigs (``p_ctg``) as FASTA, as the JAX package
    writes them (tests/test_gfa_corners.py::test_p_ctg_extraction)."""
    import shutil

    from gnnome_tpu.data.dataset import AssemblyGraphDatasetHiFi as JaxHiFi

    from gnnome_tpu_torch.data.dataset import AssemblyGraphDatasetHiFi

    out = []
    for name, cls in (("port", AssemblyGraphDatasetHiFi), ("jax", JaxHiFi)):
        ds = cls(str(tmp_path / name))
        shutil.copy(os.path.join(FIX, "hifiasm_p_ctg.gfa"),
                    os.path.join(ds.output_dir, "0_asm.bp.p_ctg.gfa"))
        ds._extract_hifiasm_contigs(0)
        with open(os.path.join(ds.output_dir, "0_assembly.fasta"), "rb") as f:
            out.append(f.read())
    assert out[0] == out[1] and out[0].startswith(b">contig_0")
