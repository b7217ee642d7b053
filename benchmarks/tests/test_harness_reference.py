"""The frozen traffic generator and the plain reference: the generator's
edge counts, its labels against the port's, TF32 rounding, and the
reference against the port on the CPU at a tiny size, through the same
run as on the card (set-up, window, check)."""
import numpy as np
import pytest
import torch

from benchmarks.harness import graphgen, runner


@pytest.mark.parametrize("nodes,edges", [
    (65_536, 302_302), (131_072, 603_536), (262_144, 1_206_922),
    (524_288, 2_411_218)])
def test_generator_edge_counts(nodes, edges):
    src, dst, *_ = graphgen.positional_graph(nodes, 0)
    assert src.shape == dst.shape == (edges,)


def test_labels_match_the_ports():
    from gnnome_tpu_torch.graphs.labels import compute_gt_labels

    src, dst, strand, start, end = graphgen.positional_graph(8192, 3)
    got = graphgen.labels(src, dst, strand, start, end)
    want = compute_gt_labels(src, dst, strand, start, end,
                             np.ones(8192, dtype=np.int16))
    assert np.array_equal(got, want) and 0.5 < got.mean() < 1.0


def test_graph_is_the_same_for_a_seed():
    a = graphgen.make_graph(4096, graphgen.graph_seed(2 ** 33 + 5, 1))
    b = graphgen.make_graph(4096, graphgen.graph_seed(2 ** 33 + 5, 1))
    c = graphgen.make_graph(4096, graphgen.graph_seed(-(2 ** 33 + 5), 1))
    assert np.array_equal(a.src, b.src) and np.array_equal(
        a.overlap_length, b.overlap_length)
    assert not np.array_equal(a.src, c.src)
    assert (a.overlap_length > 0).all() and len(np.unique(
        a.overlap_length)) > 100


def test_tf32_rounding():
    from benchmarks.harness.manifest import load_module

    ref = load_module("reference", "symgatedgcn.py")
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, 1 + 2 ** -12,
                      -(1 + 3 * 2 ** -11), 3.0e-20], dtype=torch.float32)
    r = ref._round_tf32(x)
    assert r.tolist()[:4] == [1.0, 1 + 2 ** -9, 1.0, -(1 + 2 ** -9)]
    assert (r.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("cell,override", [
    ("train-b64-g524k", {"nodes": 2048}),
    ("train-ln64-g262k", {"nodes": 2048}),
    ("score-b64-mix", {"graphs": [256, 512, 1024, 2048]})])
def test_reference_against_the_port(cell, override):
    r = runner.run_cell(cell, 2 ** 31 + 11, 2.0, False, "cpu",
                        traffic_override=override)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 1
