"""gnnome_tpu_torch's GFA route (``graphs/gfa.py``, ``graphs/paf.py``,
``graphs/analyze.py``) against the JAX package's, on every in-repo GFA
fixture and on corrupted GFAs.

Both parsers compute the overlap similarities through the same native C++
code (each package its own build of the same source), so every array is
compared exactly: the ``AssemblyGraph`` (similarities and training labels
included), the packed ``ReadStore`` (blob and offsets), and the
``read_to_node`` / ``node_to_read`` maps.  A corrupted GFA must raise the
same exception class with the same message in both packages, or parse to
the same graph in both.
"""
import dataclasses
import os

import numpy as np
import pytest

from gnnome_tpu.graphs import analyze as jax_analyze
from gnnome_tpu.graphs import paf as jax_paf
from gnnome_tpu.graphs import parse_gfa as jax_parse_gfa

from gnnome_tpu_torch.graphs import analyze, paf, parse_gfa
from gnnome_tpu_torch.graphs.synthetic import (random_genome,
                                               simulate_reads_from_genome,
                                               write_synthetic_gfa)
from gnnome_tpu_torch.utils.fastx import read_fastx, write_fasta

FIX = os.path.join(os.path.dirname(__file__), "fixtures")

# (GFA, reads file or None, whether the reads carry training positions)
FIXTURES = [
    ("hifiasm_bp_raw_r_utg.gfa", "hifi_reads.fasta", True),
    ("hifiasm_8col_r_utg.gfa", "hifi_reads.fasta", True),
    ("hifiasm_multichr_r_utg.gfa", "hifi_reads_multichr.fasta", True),
    ("hifiasm_multichr_r_utg.gfa", "hifi_reads_multichr.fasta.gz", True),
    ("hifiasm_circular_utg.gfa", None, False),
    ("raven_graph_1.gfa", "ont_reads.fasta", True),
    ("raven_graph_1.gfa", None, False),
    ("raven_graph_1_noseq.gfa", "ont_reads.fasta", True),
]
CASES = [(gfa, reads, training, sims)
         for gfa, reads, trains in FIXTURES
         for training in ((False, True) if trains else (False,))
         for sims in (False, True)]


def _fix(name):
    return None if name is None else os.path.join(FIX, name)


def assert_same_parsed(got, ref):
    """Every array of the graph, the read store and both maps, exactly."""
    assert type(got).__name__ == type(ref).__name__ == "ParsedGraph"
    g, r = got.graph, ref.graph
    assert g.num_nodes == r.num_nodes
    for f in dataclasses.fields(r):
        if not f.compare or f.name == "num_nodes":
            continue
        a, b = getattr(g, f.name), getattr(r, f.name)
        if b is None:
            assert a is None, f.name
            continue
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert got.reads._blob == ref.reads._blob
    np.testing.assert_array_equal(got.reads._offsets, ref.reads._offsets)
    assert got.reads._offsets.dtype == ref.reads._offsets.dtype
    assert got.read_to_node == ref.read_to_node
    assert got.node_to_read == ref.node_to_read


@pytest.mark.parametrize("gfa,reads,training,sims", CASES)
def test_parse_gfa_matches_jax(gfa, reads, training, sims):
    kw = dict(reads_path=_fix(reads), training=training,
              get_similarities=sims, n_threads=2)
    got, ref = parse_gfa(_fix(gfa), **kw), jax_parse_gfa(_fix(gfa), **kw)
    assert_same_parsed(got, ref)
    assert (got.graph.y is not None) == training
    assert (got.graph.overlap_similarity is not None) == sims


# ---------------------------------------------------------------- errors
def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except Exception as e:              # compared by class name and message
        return type(e).__name__, str(e)


def assert_same_outcome(path, **kw):
    got = _outcome(parse_gfa, path, **kw)
    ref = _outcome(jax_parse_gfa, path, **kw)
    assert got[0] == ref[0], (got, ref)
    if got[0] == "ok":
        assert_same_parsed(got[1], ref[1])
    else:
        assert got[1] == ref[1]
    return got[0]


@pytest.fixture(scope="module")
def valid_gfa(tmp_path_factory):
    """tests/test_gfa_fuzz.py's valid raven GFA (seed 11, 40 reads)."""
    tmp = tmp_path_factory.mktemp("torch_gfa_fuzz")
    rng = np.random.default_rng(11)
    genome = random_genome(6000, rng)
    records, starts, ends, strands = simulate_reads_from_genome(
        genome, 40, 600, rng)
    gfa, reads = str(tmp / "g.gfa"), str(tmp / "reads.fasta")
    write_synthetic_gfa(records, starts, ends, strands, gfa, reads,
                        dialect="raven")
    with open(gfa) as f:
        text = f.read()
    return gfa, reads, text


def _write(tmp_path, name, text):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        f.write(text)
    return p


def test_byte_truncations_fail_alike(valid_gfa, tmp_path):
    """tests/test_gfa_fuzz.py:55-73: cuts mid-line and at line ends."""
    _, _, text = valid_gfa
    rng = np.random.default_rng(0)
    newlines = [i + 1 for i, ch in enumerate(text) if ch == "\n"]
    offsets = sorted(set(rng.integers(1, len(text), size=12).tolist()
                         + newlines[:: max(1, len(newlines) // 4)]))
    outcomes = {assert_same_outcome(_write(tmp_path, f"t{i}.gfa", text[:o]))
                for i, o in enumerate(offsets)}
    assert "ok" in outcomes and "GFAFormatError" in outcomes


def test_line_truncations_fail_alike(valid_gfa, tmp_path):
    """tests/test_gfa_fuzz.py:76-89: trailing fields dropped."""
    _, _, text = valid_gfa
    lines = text.splitlines()
    for li in (0, len(lines) // 2, len(lines) - 1):
        fields = lines[li].split("\t")
        for keep in range(1, len(fields)):
            mutated = lines.copy()
            mutated[li] = "\t".join(fields[:keep])
            assert_same_outcome(_write(tmp_path, "cut.gfa",
                                       "\n".join(mutated) + "\n"))


L_MUTATIONS = {
    "cigar_without_M": lambda l: l.replace("M", "", 1),
    "cigar_garbage": lambda l: l.replace("M", "xM", 1),
    "cigar_other_op": lambda l: l.replace("M", "Q"),
    "bad_orientation": lambda l: "\t".join(
        f if i != 2 else "*" for i, f in enumerate(l.split("\t"))),
    "unknown_segment": lambda l: "\t".join(
        f if i != 1 else "nosuchread" for i, f in enumerate(l.split("\t"))),
    "nine_fields": lambda l: l + "\tx\ty\tz",
    "hifiasm_ids_without_range": lambda l: l + "\tx",
}
S_MUTATIONS = {
    "missing_ln": lambda f: f[:3],
    "wrong_tag": lambda f: f[:3] + ["LN:x:12"],
    "bad_length": lambda f: f[:3] + ["LN:i:abc"],
    "two_fields": lambda f: f[:2],
}


@pytest.mark.parametrize("name", sorted(L_MUTATIONS))
def test_l_record_corruption_fails_alike(valid_gfa, tmp_path, name):
    """tests/test_gfa_fuzz.py:92-113 and :132-144."""
    _, _, text = valid_gfa
    lines = text.splitlines()
    li = next(i for i, l in enumerate(lines) if l.startswith("L"))
    lines[li] = L_MUTATIONS[name](lines[li])
    p = _write(tmp_path, "mut.gfa", "\n".join(lines) + "\n")
    assert assert_same_outcome(p) == "GFAFormatError"


@pytest.mark.parametrize("name", sorted(S_MUTATIONS))
def test_s_record_corruption_fails_alike(valid_gfa, tmp_path, name):
    """tests/test_gfa_fuzz.py:116-129."""
    _, _, text = valid_gfa
    lines = text.splitlines()
    si = next(i for i, l in enumerate(lines) if l.startswith("S"))
    lines[si] = "\t".join(S_MUTATIONS[name](lines[si].split("\t")))
    p = _write(tmp_path, "muts.gfa", "\n".join(lines) + "\n")
    assert assert_same_outcome(p) == "GFAFormatError"


def test_missing_read_header_fails_alike(valid_gfa, tmp_path):
    """tests/test_gfa_fuzz.py:147-156: a read the reads file lacks."""
    gfa, reads, _ = valid_gfa
    short = str(tmp_path / "short.fasta")
    write_fasta(list(read_fastx(reads))[:-1], short)
    assert assert_same_outcome(gfa, reads_path=short,
                               training=True) == "GFAFormatError"


@pytest.mark.parametrize("gfa,reads,training,err", [
    ("raven_graph_1_noseq.gfa", None, False, "ValueError"),
    ("raven_graph_1.gfa", None, True, "ValueError"),
    ("hifiasm_bp_raw_r_utg.gfa", "ont_reads.fasta", True, "GFAFormatError"),
    ("hifiasm_circular_utg.gfa", "hifi_reads.fasta", True,
     "GFAFormatError"),
])
def test_fixture_misuse_fails_alike(gfa, reads, training, err):
    """A '*'-sequence GFA without reads, training without reads, and reads
    that do not belong to the GFA (tests/test_real_format_gfa.py:119-121)."""
    assert assert_same_outcome(_fix(gfa), reads_path=_fix(reads),
                               training=training) == err


def test_a_unitig_graph_of_star_sequences_fails_alike(tmp_path):
    """'*' sequences in a unitig graph need the unitig sequences."""
    with open(_fix("hifiasm_bp_raw_r_utg.gfa")) as f:
        lines = f.read().splitlines()
    out = []
    for line in lines:
        f = line.split("\t")
        if f[0] == "S":
            f[2] = "*"
        out.append("\t".join(f))
    p = _write(tmp_path, "star_utg.gfa", "\n".join(out) + "\n")
    assert assert_same_outcome(p, reads_path=_fix("hifi_reads.fasta")) \
        == "ValueError"


# ------------------------------------------------------------------- PAF
def _write_paf(path, parsed, seed):
    """A PAF over the parsed graph's reads: a record for each real edge,
    half of them written target-first, with seeded coordinates."""
    rng = np.random.default_rng(seed)
    g = parsed.graph

    def rid(node):
        r = parsed.node_to_read[node]
        return r if isinstance(r, str) else r[0][0]

    lines = []
    for s, d in zip(g.src.tolist(), g.dst.tolist()):
        if s % 2:
            continue
        a, b = (rid(s), rid(d)) if rng.random() < 0.5 else (rid(d), rid(s))
        la, lb = rng.integers(800, 2000, 2)
        sa, sb = rng.integers(0, 300, 2)
        ea, eb = la - rng.integers(0, 30), lb - rng.integers(0, 300)
        strand = "+" if rng.random() < 0.7 else "-"
        lines.append(f"{a}\t{la}\t{sa}\t{ea}\t{strand}\t{b}\t{lb}\t{sb}\t{eb}"
                     f"\t100\t200\t60")
    lines.append("short\tline")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("gfa,reads", [
    ("raven_graph_1.gfa", "ont_reads.fasta"),
    ("hifiasm_bp_raw_r_utg.gfa", "hifi_reads.fasta")])
def test_paf_parity(tmp_path, gfa, reads):
    parsed = parse_gfa(_fix(gfa), reads_path=_fix(reads))
    path = str(tmp_path / "ovl.paf")
    _write_paf(path, parsed, seed=5)
    got, ref = paf.parse_paf(path), jax_paf.parse_paf(path)
    assert got == ref and len(got) > 0
    info = paf.edge_paf_info(parsed.graph, got, parsed.node_to_read)
    assert info == jax_paf.edge_paf_info(parsed.graph, ref,
                                         parsed.node_to_read)
    assert len(info) > 0


# --------------------------------------------------------------- analyze
def test_print_pairwise_byte_for_byte(tmp_path):
    parsed = parse_gfa(_fix("raven_graph_1.gfa"))
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    analyze.print_pairwise(parsed.graph, str(a))
    jax_analyze.print_pairwise(parsed.graph, str(b))
    assert a.read_bytes() == b.read_bytes() and a.stat().st_size > 0


def test_walk_diagnostics_match_jax():
    parsed = parse_gfa(_fix("hifiasm_multichr_r_utg.gfa"),
                       reads_path=_fix("hifi_reads_multichr.fasta"),
                       training=True)
    g = parsed.graph
    walk = [0, 2, 4, 6, 8]
    for fn in ("assert_strand", "assert_chromosome", "assert_overlap"):
        assert getattr(analyze, fn)(g, walk) == getattr(jax_analyze, fn)(
            g, walk), fn
    assert analyze.interval_union(g) == jax_analyze.interval_union(g)
