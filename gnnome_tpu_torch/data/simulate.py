"""Training-data generation: PBSIM3 read simulation + graph construction.

Reference ``generate_data.py``: per chromosome, simulate HiFi reads with PBSIM3
(``--strategy wgs --method sample``, generate_data.py:129-134), rewrite read
headers with ground-truth ``strand/start/end/chr`` parsed from the MAF
alignments (generate_data.py:43-60), then build assembly graphs through the
dataset ``process()`` path.

The MAF parsing is dependency-free (the reference uses Bio.AlignIO).
"""
from __future__ import annotations

import os
import re
import subprocess

from ..config import Config
from ..utils.fastx import FastxRecord, read_fastx, write_fasta
from .chromosomes import get_train_valid_chrs, merge_dicts
from .dataset import dataset_for


class InvalidSuffixError(Exception):
    def __init__(self):
        super().__init__("Invalid chromosome suffix; only '_hg002' is supported "
                         "(e.g. 'chr6_hg002').")


def change_description_seqreq(file_path: str) -> None:
    """Legacy SeqRequester header rewrite (reference generate_data.py:25-40):
    ``read=N,forward,position=a-b`` -> ``strand/start/end`` convention."""
    records = []
    for r in read_fastx(file_path):
        des = r.description.split(",")
        rid = des[0][5:]
        strand = "+" if des[1] == "forward" else "-"
        start, end = des[2][9:].split("-")
        records.append(FastxRecord(
            id=rid, description=f"{rid} strand={strand} start={start} end={end}",
            seq=r.seq))
    write_fasta(records, file_path)


def parse_maf_positions(maf_path: str) -> dict[str, tuple[str, int, int]]:
    """read id -> (strand, ref_start, ref_end) from a PBSIM3 MAF file.

    PBSIM emits per alignment block: an 'a' line, an 's' line for the
    reference and an 's' line for the read (strand in field 5, size in
    field 4; ``read == ref[start:start+size]``, generate_data.py:46-53).
    """
    out = {}
    with open(maf_path) as f:
        block: list[list[str]] = []
        for line in f:
            if line.startswith("a"):
                block = []
            elif line.startswith("s"):
                block.append(line.split())
                if len(block) == 2:
                    ref, read = block
                    start = int(ref[2])
                    end = start + int(ref[3])
                    strand = "+" if read[4] == "+" else "-"
                    out[read[1]] = (strand, start, end)
    return out


def annotate_pbsim_reads(fastq_path: str, maf_path: str, chrom: int) -> str:
    """Rewrite simulated-read headers with GT positions; returns the new
    FASTA path (reference generate_data.py:43-60)."""
    positions = parse_maf_positions(maf_path)
    records = []
    for r in read_fastx(fastq_path):
        strand, start, end = positions[r.id]
        rid = f"{r.id}_chr{chrom}"
        records.append(FastxRecord(
            id=rid,
            description=f"{rid} strand={strand} start={start} end={end} chr={chrom}",
            seq=r.seq))
    fasta_path = fastq_path[:-1] + "a" if fastq_path.endswith("q") \
        else fastq_path + ".fasta"
    write_fasta(records, fasta_path)
    os.remove(fastq_path)
    return fasta_path


def simulate_reads_hifi(datadir: str, chrs_path: str, chr_dict: dict,
                        assembler: str, cfg: Config) -> None:
    """PBSIM3 per chromosome to the needed dataset counts
    (reference generate_data.py:88-135)."""
    datadir = os.path.abspath(datadir)
    chrs_path = os.path.abspath(chrs_path)
    pbsim_dir = cfg.paths.pbsim3_dir
    profile = cfg.data.sample_profile_id
    depth = cfg.data.sequencing_depth

    for chr_flag, n_need in chr_dict.items():
        if chr_flag.endswith("_r") or "+" in chr_flag:
            continue
        if not chr_flag.endswith("_hg002"):
            raise InvalidSuffixError
        chrN = chr_flag[:-6]
        chr_seq_path = os.path.join(chrs_path, f"{chrN}.fasta")
        chr_raw = os.path.join(datadir, chrN, "raw")
        chr_prc = os.path.join(datadir, chrN, assembler, "processed")
        os.makedirs(chr_raw, exist_ok=True)
        os.makedirs(chr_prc, exist_ok=True)

        have = {int(m.group(1)) for f in os.listdir(chr_raw)
                if (m := re.match(r"(\d+)\.fast", f))}
        have |= {int(m.group(1)) for f in os.listdir(chr_prc)
                 if (m := re.match(r"(\d+)\.npz", f))}
        n_have = max(have) + 1 if have else 0
        for i in range(max(0, n_need - n_have)):
            idx = n_have + i
            if not profile:
                raise ValueError("PBSIM3 sample profile id unset "
                                 "(config data.sample_profile_id)")
            sample_arg = ""
            if f"sample_profile_{profile}.fastq" not in os.listdir(pbsim_dir):
                assert os.path.isfile(cfg.data.sample_file), \
                    "Sample profile not found; provide data.sample_file"
                sample_arg = f"--sample {cfg.data.sample_file} "
            subprocess.run(
                f"./src/pbsim --strategy wgs --method sample --depth {depth} "
                f"--genome {chr_seq_path} {sample_arg}"
                f"--sample-profile-id {profile} --prefix {chr_raw}/{idx}",
                shell=True, cwd=pbsim_dir, check=True)
            # normalise pbsim output names (generate_data.py:69-84)
            os.replace(f"{chr_raw}/{idx}_0001.fastq", f"{chr_raw}/{idx}.fastq")
            os.replace(f"{chr_raw}/{idx}_0001.maf", f"{chr_raw}/{idx}.maf")
            ref_file = f"{chr_raw}/{idx}_0001.ref"
            if os.path.isfile(ref_file):
                os.remove(ref_file)
            chrom = int(chrN[3:]) if chrN[3:].isdigit() else chrN[3:]
            annotate_pbsim_reads(f"{chr_raw}/{idx}.fastq",
                                 f"{chr_raw}/{idx}.maf", chrom)
            os.remove(f"{chr_raw}/{idx}.maf")


def generate_graphs_hifi(datadir: str, chr_dict: dict, assembler: str,
                         threads: int, cfg: Config) -> None:
    """Build graphs for all simulated chromosomes (generate_data.py:139-155)."""
    datadir = os.path.abspath(datadir)
    for chr_flag, n_need in chr_dict.items():
        if not chr_flag.endswith("_hg002"):
            raise InvalidSuffixError
        chrN = chr_flag[:-6]
        chr_dir = os.path.join(datadir, chrN)
        prc = os.path.join(chr_dir, assembler, "processed")
        if n_need > len(os.listdir(prc)):
            dataset_for(assembler, chr_dir, threads=threads, generate=True,
                        n_need=n_need, config=cfg)


def simulate_and_generate(datadir: str, chrdir: str, assembler: str,
                          threads: int, cfg: Config | None = None,
                          chrs_config: str | None = None) -> None:
    cfg = cfg or Config()
    train_chr, valid_chr = get_train_valid_chrs(chrs_config)
    all_chr = merge_dicts(train_chr, valid_chr)
    simulate_reads_hifi(datadir, chrdir, all_chr, assembler, cfg)
    generate_graphs_hifi(datadir, all_chr, assembler, threads, cfg)
