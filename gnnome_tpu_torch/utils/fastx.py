"""FASTA/FASTQ I/O without external dependencies.

The reference uses Biopython (``Bio.SeqIO``) for reads + headers
(reference graph_parser.py:128-135, generate_data.py:45-47).  Biopython is not a
dependency here; this module provides the same capability with plain Python,
including gzip support and the header conventions used for training labels
(``strand=+ start=123 end=456 chr=19``, reference graph_parser.py:219-222).
"""
from __future__ import annotations

import gzip
import io
import re
from dataclasses import dataclass
from typing import Iterator, Sequence

_COMP = str.maketrans("ACGTacgtNnRYSWKMBDHVryswkmbdhv",
                      "TGCAtgcaNnYRSWMKVHDBYRSWMKVHDB")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


@dataclass
class FastxRecord:
    id: str
    description: str   # full header line minus '>'/'@' (includes the id)
    seq: str


def detect_filetype(path: str) -> str:
    """'fasta' or 'fastq' by extension (reference graph_parser.py:123-134)."""
    p = path[:-3] if path.endswith(".gz") else path
    if p.endswith((".fasta", ".fna", ".fa")):
        return "fasta"
    if p.endswith((".fastq", ".fnq", ".fq")):
        return "fastq"
    raise ValueError(f"Cannot detect FASTA/Q filetype from path: {path}")


def _open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path)


def read_fastx(path: str, filetype: str | None = None) -> Iterator[FastxRecord]:
    """Stream records from a FASTA/FASTQ file, optionally gzipped."""
    filetype = filetype or detect_filetype(path)
    with _open_text(path) as f:
        if filetype == "fasta":
            header, chunks = None, []
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line.startswith(">"):
                    if header is not None:
                        yield _make_record(header, "".join(chunks))
                    header, chunks = line[1:], []
                else:
                    chunks.append(line.strip())
            if header is not None:
                yield _make_record(header, "".join(chunks))
        else:
            while True:
                header = f.readline().rstrip("\n")
                if not header:
                    break
                seq = f.readline().strip()
                f.readline()  # +
                f.readline()  # qualities
                yield _make_record(header[1:], seq)


def _make_record(header: str, seq: str) -> FastxRecord:
    rid = header.split()[0] if header.split() else header
    return FastxRecord(id=rid, description=header, seq=seq)


def write_fasta(records: Sequence[FastxRecord], path: str, line_width: int = 0) -> None:
    """Write records as FASTA.  ``line_width=0`` emits 2-line records
    (matching the reference's 'fasta-2line' output, generate_data.py:58)."""
    opener = gzip.open(path, "wt") if path.endswith(".gz") else open(path, "w")
    with opener as f:
        for r in records:
            desc = r.description if r.description else r.id
            f.write(f">{desc}\n")
            if line_width and line_width > 0:
                for i in range(0, len(r.seq), line_width):
                    f.write(r.seq[i:i + line_width] + "\n")
            else:
                f.write(r.seq + "\n")


_STRAND_RE = re.compile(r"strand=(\+|\-)")
_START_RE = re.compile(r"start=(\d+)")
_END_RE = re.compile(r"end=(\d+)")
_CHR_RE = re.compile(r"chr=([0-9XYM]+)")


def parse_training_header(description: str) -> tuple[int, int, int, int]:
    """Parse ``strand/start/end/chr`` ground truth from a simulated-read header.

    Returns (strand ±1, start, end, chr) with X/Y/M encoded as -1/-2/-3
    (reference graph_parser.py:219-230).
    """
    strand = 1 if _STRAND_RE.findall(description)[0] == "+" else -1
    start = int(_START_RE.findall(description)[0])
    end = int(_END_RE.findall(description)[0])
    chrom = _CHR_RE.findall(description)[0]
    if chrom in ("X", "Y", "M"):
        chrom = {"X": -1, "Y": -2, "M": -3}[chrom]
    else:
        chrom = int(chrom)
    return strand, start, end, chrom


def format_training_header(read_id: str, strand: int, start: int, end: int, chrom) -> str:
    s = "+" if strand >= 0 else "-"
    return f"{read_id} strand={s} start={start} end={end} chr={chrom}"
