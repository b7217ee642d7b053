"""On-disk assembly-graph dataset.

Directory layout mirrors the reference (graph_dataset.py:14-44) so pipelines
translate directly:

    <root>/raw/{idx}.fasta|fastq        input reads
    <root>/<assembler>/output/           assembler scratch
    <root>/<assembler>/processed/{idx}.npz   AssemblyGraph (was {idx}.dgl)
    <root>/<assembler>/info/{idx}_reads.npz  packed ReadStore
    <root>/<assembler>/info/{idx}_aux.pkl    read_to_node / node_to_read maps

``process()`` invokes the same external assemblers with the same flags
(hifiasm ``--prt-raw -l0`` -> ``.bp.raw.r_utg.gfa``, graph_dataset.py:119-122;
raven ``-p0`` -> ``graph_1.gfa``, graph_dataset.py:107-108,170-173) and then
parses with training labels + similarities (graph_dataset.py:128,177);
``save_parsed`` (``cli build-graph``) parses any GFA into the layout and
reports the seconds of its stages.  The dataset is what
``gnnome_tpu.data.dataset`` writes, file for file.  Unlike the reference's
eager constructor, graphs are loaded lazily.
"""
from __future__ import annotations

import os
import pickle
import re
import shlex
import subprocess

from ..config import Config
from ..graphs import AssemblyGraph, ReadStore, parse_gfa
from ..graphs.analyze import print_pairwise
from ..graphs.similarity import overlap_similarities
from ..utils.timing import Timer


def _npz_indices(save_dir: str) -> set[int]:
    """Graph indices from "<digits>.npz" filenames; foreign .npz files
    (backups, "12.old.npz") are ignored instead of crashing discovery."""
    out = set()
    for f in os.listdir(save_dir):
        m = re.fullmatch(r"(\d+)\.npz", f)
        if m:
            out.add(int(m.group(1)))
    return out


class AssemblyGraphDataset:
    assembler = "hifiasm"

    def __init__(self, root: str, assembler: str | None = None, threads: int = 1,
                 generate: bool = False, n_need: int = 0,
                 config: Config | None = None, cache: bool = True):
        self.root = os.path.abspath(root)
        # in-memory graph cache: the reference dataset keeps every graph
        # loaded for the whole run (graph_dataset.py:47-56); epoch 2+ of the
        # training loop then does zero disk reads
        self.cache = cache
        self._graph_cache: dict[int, AssemblyGraph] = {}
        if assembler:
            self.assembler = assembler
        self.threads = threads
        self.n_need = n_need
        self.config = config or Config()

        self.assembly_dir = os.path.join(self.root, self.assembler)
        self.raw_dir = os.path.join(self.root, "raw")
        self.output_dir = os.path.join(self.assembly_dir, "output")
        self.save_dir = os.path.join(self.assembly_dir, "processed")
        self.info_dir = os.path.join(self.assembly_dir, "info")
        for d in (self.raw_dir, self.output_dir, self.save_dir, self.info_dir):
            os.makedirs(d, exist_ok=True)

        if generate and not self.has_cache():
            self.process()

        self.indices = sorted(_npz_indices(self.save_dir))

    # ------------------------------------------------------------------ access
    def __len__(self) -> int:
        return len(self.indices)

    def __iter__(self):
        for idx in self.indices:
            yield idx, self.load_graph(idx)

    def __getitem__(self, i: int):
        idx = self.indices[i]
        return idx, self.load_graph(idx)

    def load_graph(self, idx: int) -> AssemblyGraph:
        g = self._graph_cache.get(idx)
        if g is None:
            g = AssemblyGraph.load(os.path.join(self.save_dir, f"{idx}.npz"))
            if self.cache:
                self._graph_cache[idx] = g
        return g

    def load_reads(self, idx: int) -> ReadStore:
        return ReadStore.load(os.path.join(self.info_dir, f"{idx}_reads.npz"))

    def load_aux(self, idx: int) -> dict:
        with open(os.path.join(self.info_dir, f"{idx}_aux.pkl"), "rb") as f:
            return pickle.load(f)

    def has_cache(self) -> bool:
        prc = _npz_indices(self.save_dir)
        return len(set(range(self.n_need)) - prc) == 0

    # ----------------------------------------------------------------- process
    def _raw_reads_path(self, idx: int) -> str:
        for ext in ("fasta", "fastq", "fasta.gz", "fastq.gz", "fa", "fq"):
            p = os.path.join(self.raw_dir, f"{idx}.{ext}")
            if os.path.isfile(p):
                return p
        raise FileNotFoundError(f"No raw reads for index {idx} in {self.raw_dir}")

    def _assemble(self, idx: int, reads_path: str) -> str:
        """Run the external assembler; returns the GFA path.  Only the
        subclasses that ``dataset_for`` returns know their assembler."""
        raise TypeError(f"{type(self).__name__} runs no assembler; make the "
                        "dataset with dataset_for('hifiasm' | 'raven', ...)")

    def process(self) -> None:
        prc = _npz_indices(self.save_dir)
        for idx in sorted(set(range(self.n_need)) - prc):
            reads_path = self._raw_reads_path(idx)
            gfa_path = self._assemble(idx, reads_path)
            self.save_parsed(idx, gfa_path, reads_path, training=True)

    def save_parsed(self, idx: int, gfa_path: str, reads_path: str,
                    training: bool) -> dict:
        """Parse ``gfa_path`` (labels from ``reads_path``'s headers when
        ``training``), compute the overlap similarities and write graph
        ``idx``; returns the seconds of each stage (``parse``,
        ``similarities``, ``save``)."""
        timer = Timer("build.")
        with timer.phase("parse"):
            parsed = parse_gfa(gfa_path, reads_path=reads_path,
                               training=training)
        with timer.phase("similarities"):
            g = parsed.graph
            g.overlap_similarity = overlap_similarities(
                g.src, g.dst, g.overlap_length, parsed.reads,
                n_threads=self.threads)
        with timer.phase("save"):
            g.save(os.path.join(self.save_dir, f"{idx}.npz"))
            parsed.reads.save(os.path.join(self.info_dir,
                                           f"{idx}_reads.npz"))
            with open(os.path.join(self.info_dir, f"{idx}_aux.pkl"),
                      "wb") as f:
                pickle.dump({"read_to_node": parsed.read_to_node,
                             "node_to_read": parsed.node_to_read}, f)
            # Graphia-compatible pairwise export (graph_dataset.py:135-136)
            graphia_dir = os.path.join(self.assembly_dir, "graphia")
            os.makedirs(graphia_dir, exist_ok=True)
            print_pairwise(g, os.path.join(graphia_dir, f"{idx}_graph.txt"))
        return dict(timer.phases)


class AssemblyGraphDatasetHiFi(AssemblyGraphDataset):
    """HiFi reads -> hifiasm raw unitig graph (graph_dataset.py:76-137)."""
    assembler = "hifiasm"

    def _assemble(self, idx: int, reads_path: str) -> str:
        hifiasm = os.path.abspath(os.path.join(self.config.paths.hifiasm_dir, "hifiasm"))
        subprocess.run(
            f"{shlex.quote(hifiasm)} --prt-raw -o {idx}_asm "
            f"-t{self.threads} -l0 {shlex.quote(reads_path)}",
            shell=True, cwd=self.output_dir, check=True)
        gfa = os.path.join(self.output_dir, f"{idx}_raw_graph.gfa")
        os.replace(os.path.join(self.output_dir, f"{idx}_asm.bp.raw.r_utg.gfa"), gfa)
        self._extract_hifiasm_contigs(idx)
        for f in os.listdir(self.output_dir):  # clean scratch (graph_dataset.py:124)
            if f.startswith(f"{idx}_asm"):
                os.remove(os.path.join(self.output_dir, f))
        return gfa

    def _extract_hifiasm_contigs(self, idx: int) -> None:
        """Keep hifiasm's own contigs for comparison (utils/data_utils.py:13-27)."""
        from ..utils.fastx import FastxRecord, write_fasta
        gfa = os.path.join(self.output_dir, f"{idx}_asm.bp.p_ctg.gfa")
        if not os.path.isfile(gfa):
            return
        contigs = []
        with open(gfa) as f:
            n = 0
            for line in f:
                if line.startswith("S"):
                    seq = line.split()[2]
                    contigs.append(FastxRecord(f"contig_{n}", f"contig_{n}", seq))
                    n += 1
        write_fasta(contigs, os.path.join(self.output_dir, f"{idx}_assembly.fasta"))


class AssemblyGraphDatasetONT(AssemblyGraphDataset):
    """ONT reads -> raven graph (graph_dataset.py:140-186)."""
    assembler = "raven"

    def _assemble(self, idx: int, reads_path: str) -> str:
        raven = os.path.abspath(os.path.join(self.config.paths.raven_dir,
                                             "build/bin/raven"))
        subprocess.run(
            f"{shlex.quote(raven)} --disable-checkpoints -t{self.threads} "
            f"-p0 {shlex.quote(reads_path)} > {idx}_assembly.fasta",
            shell=True, cwd=self.output_dir, check=True)
        gfa = os.path.join(self.output_dir, f"{idx}_graph_1.gfa")
        os.replace(os.path.join(self.output_dir, "graph_1.gfa"), gfa)
        return gfa


def dataset_for(assembler: str, *args, **kw) -> AssemblyGraphDataset:
    cls = {"hifiasm": AssemblyGraphDatasetHiFi,
           "raven": AssemblyGraphDatasetONT}.get(assembler)
    if cls is None:
        raise ValueError(f"Unknown assembler: {assembler}")
    return cls(*args, **kw)
