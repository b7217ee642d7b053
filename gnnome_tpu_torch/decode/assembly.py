"""Assembly emission + contiguity metrics (reference utils/evaluate.py).

``walks_to_contigs`` concatenates, per walk, each read's prefix
(``read[:prefix_length]``) and the full final read (evaluate.py:38-48).
N50/NG50 match evaluate.py:56-91; the CHM13 chromosome-length table
(evaluate.py:11-35) is kept for NG50 denominators.  The external
minigraph/paftools evaluation (evaluate.py:139-157) is wired with
*configurable* tool paths instead of the reference's hardcoded home paths.
"""
from __future__ import annotations

import os
import subprocess

import numpy as np

from ..utils.fastx import FastxRecord, write_fasta

CHM13_CHR_LENS = {
    "chr1": 248387328, "chr2": 242696752, "chr3": 201105948, "chr4": 193574945,
    "chr5": 182045439, "chr6": 172126628, "chr7": 160567428, "chr8": 146259331,
    "chr9": 150617247, "chr10": 134758134, "chr11": 135127769, "chr12": 133324548,
    "chr13": 113566686, "chr14": 101161492, "chr15": 99753195, "chr16": 96330374,
    "chr17": 84276897, "chr18": 80542538, "chr19": 61707364, "chr20": 66210255,
    "chr21": 45090682, "chr22": 51324926, "chrX": 154259566,
}


def walks_to_contigs(walks, graph, reads) -> list[FastxRecord]:
    """Contig sequences from walks (reference evaluate.py:38-48)."""
    prefix = np.maximum(np.asarray(graph.prefix_length, dtype=np.int64), 0)
    contigs = []
    for i, walk in enumerate(walks):
        parts = []
        for u, v in zip(walk[:-1], walk[1:]):
            e = graph.edge_id(int(u), int(v))
            parts.append(reads.get(int(u))[: int(prefix[e])])
        parts.append(reads.get(int(walk[-1])))
        seq = "".join(parts)
        contigs.append(FastxRecord(id=f"contig_{i+1}",
                                   description=f"contig_{i+1} length={len(seq)}",
                                   seq=seq))
    return contigs


def save_assembly(contigs, save_dir: str, idx, suffix: str = "") -> str:
    path = os.path.join(save_dir, f"{idx}_assembly{suffix}.fasta")
    write_fasta(contigs, path)
    return path


def calculate_n50(lengths) -> int:
    lengths = sorted((int(l) for l in lengths), reverse=True)
    total = sum(lengths)
    acc = 0
    for l in lengths:
        acc += l
        if acc >= total / 2:
            return l
    return -1


def calculate_ng50(lengths, ref_length: int) -> int:
    if ref_length <= 0:
        return -1
    lengths = sorted((int(l) for l in lengths), reverse=True)
    acc = 0
    for l in lengths:
        acc += l
        if acc >= ref_length / 2:
            return l
    return -1


def quick_evaluation(contigs, chrN: str | None = None,
                     ref_length: int | None = None) -> dict:
    """Summary metrics (reference evaluate.py:93-105)."""
    lengths = [len(c.seq) for c in contigs]
    if ref_length is None and chrN:
        ref_length = CHM13_CHR_LENS.get(chrN, -1)
    out = {
        "num_contigs": len(contigs),
        "longest_contig": max(lengths) if lengths else 0,
        "total_bases": sum(lengths),
        "n50": calculate_n50(lengths) if lengths else -1,
    }
    if ref_length and ref_length > 0:
        out["reconstructed"] = sum(lengths) / ref_length
        out["ng50"] = calculate_ng50(lengths, ref_length)
    return out


def write_report(data_path: str, idx, ev: dict) -> str:
    """Per-graph assembly report file (reference evaluate.py:113-125)."""
    reports_dir = os.path.join(data_path, "reports")
    os.makedirs(reports_dir, exist_ok=True)
    path = os.path.join(reports_dir, f"{idx}_report.txt")
    with open(path, "w") as f:
        lines = ["-" * 80, f"Report for graph {idx} in {data_path}"]
        lines += [f"Num contigs:\t{ev.get('num_contigs')}",
                  f"Longest contig:\t{ev.get('longest_contig')}",
                  f"N50:\t{ev.get('n50')}"]
        if "reconstructed" in ev:
            lines.append(f"Reconstructed:\t{ev['reconstructed'] * 100:2f}%")
        if "ng50" in ev:
            lines.append(f"NG50:\t{ev['ng50']}")
        for t in lines:
            print(t)
            f.write(t + "\n")
    return path


def run_minigraph(ref: str, asm: str, paf: str, minigraph: str = "minigraph",
                  threads: int = 32) -> subprocess.Popen:
    """External NG50/NGA50 eval (reference evaluate.py:139-148)."""
    cmd = f"{minigraph} -t{threads} -xasm -g10k -r10k --show-unmap=yes {ref} {asm}".split()
    f = open(paf, "w")
    return subprocess.Popen(cmd, stdout=f)


def parse_pafs(idx_path: str, report: str, paf: str,
               paftools: str = "paftools.js", k8: str = "k8") -> subprocess.Popen:
    cmd = f"{k8} {paftools} asmstat {idx_path} {paf}".split()
    f = open(report, "w")
    return subprocess.Popen(cmd, stdout=f)


def parse_minigraph_report(report_path: str) -> dict:
    """Extract NG50/NGA50 from a paftools asmstat report
    (reference evaluate.py:159-190)."""
    import re
    out = {}
    with open(report_path) as f:
        text = f.read()
    for key in ("NG50", "NGA50"):
        m = re.findall(rf"{key}\s*(\d+)", text)
        out[key.lower()] = int(m[0]) if m else 0
    return out
