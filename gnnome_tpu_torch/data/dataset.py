"""On-disk assembly-graph dataset.

Directory layout mirrors the reference (graph_dataset.py:14-44) so pipelines
translate directly:

    <root>/raw/{idx}.fasta|fastq        input reads
    <root>/<assembler>/output/           assembler scratch
    <root>/<assembler>/processed/{idx}.npz   AssemblyGraph (was {idx}.dgl)
    <root>/<assembler>/info/{idx}_reads.npz  packed ReadStore
    <root>/<assembler>/info/{idx}_aux.pkl    read_to_node / node_to_read maps

``process()`` and ``save_parsed()`` (run the external assembler, parse its
GFA into the layout above) need the GFA parser (``graphs/gfa.py``), which
this package does not carry yet: they raise ``NotImplementedError``.  Build a
dataset with ``gnnome_tpu.cli build-graph`` or, for tests and smoke runs,
save an ``AssemblyGraph``/``ReadStore`` pair into the layout directly.
Unlike the reference's eager constructor, graphs are loaded lazily.
"""
from __future__ import annotations

import os
import pickle
import re

from ..config import Config
from ..graphs import AssemblyGraph, ReadStore

_NO_GFA = ("building a dataset from a GFA needs the GFA parser "
           "(graphs/gfa.py), which gnnome_tpu_torch does not carry yet")


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
    def process(self) -> None:
        raise NotImplementedError(_NO_GFA)

    def save_parsed(self, idx: int, gfa_path: str, reads_path: str,
                    training: bool) -> None:
        raise NotImplementedError(_NO_GFA)


class AssemblyGraphDatasetHiFi(AssemblyGraphDataset):
    """HiFi reads -> hifiasm raw unitig graph (graph_dataset.py:76-137)."""
    assembler = "hifiasm"


class AssemblyGraphDatasetONT(AssemblyGraphDataset):
    """ONT reads -> raven graph (graph_dataset.py:140-186)."""
    assembler = "raven"


def dataset_for(assembler: str, *args, **kw) -> AssemblyGraphDataset:
    cls = {"hifiasm": AssemblyGraphDatasetHiFi,
           "raven": AssemblyGraphDatasetONT}.get(assembler)
    if cls is None:
        raise ValueError(f"Unknown assembler: {assembler}")
    return cls(*args, **kw)
