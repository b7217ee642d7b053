"""The CUDA kernels K3 and K6 against their plain PyTorch versions, on the
card.  Every test here is ``cuda``-marked and skips where no GPU is present.

This file imports neither JAX nor the JAX package, so it runs on a machine
without them; skip the JAX-importing conftest there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: e_out and z repeat the plain version's per-op rounding (only
sigmoid's exp may differ by an ulp): ``atol=1e-5`` and exact; node sums add
~30 terms in another order (the plain version scatters with atomics):
``rtol=1e-5, atol=1e-4``.
"""
import pytest
import torch

from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.ops import DeviceGraph
from gnnome_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph(cuda):
    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=20000,
                                          read_len=400, seed=70,
                                          with_sequences=False,
                                          false_edge_frac=0.15)
    return DeviceGraph.from_graph(g, cuda)


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("flip", [False, True])
def test_k3_kernel_vs_plain(graph, cuda, flip, d):
    gen = torch.Generator(device=cuda).manual_seed(5)
    N, E = graph.n_nodes, graph.n_edges
    proj = torch.randn(N, 5 * d, device=cuda, generator=gen)
    proj_u, proj_v = proj[:, :2 * d], proj[:, 2 * d:4 * d]   # strided rows
    b3e = torch.randn(E, d, device=cuda, generator=gen)
    e_in = torch.randn(E, d, device=cuda, generator=gen)
    bn = torch.stack([torch.randn(d, device=cuda, generator=gen) * 0.3,
                      torch.rand(d, device=cuda, generator=gen) + 0.5,
                      torch.rand(d, device=cuda, generator=gen) + 0.5,
                      torch.randn(d, device=cuda, generator=gen) * 0.1])
    u, v, v_csr, u_csr = graph.roles(flip)
    n0 = K.k3_edge_stage.launches
    got = K.k3_edge_stage(u, v, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn)
    assert K.k3_edge_stage.launches == n0 + 1
    ref = K.k3_edge_stage_plain(u, v, proj_u, proj_v, b3e, e_in, bn)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5)
    for x, y in zip(got[1:], ref[1:]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-4)
    again = K.k3_edge_stage(u, v, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics


@pytest.mark.parametrize("flip", [False, True])
def test_k6_kernel_vs_plain(graph, cuda, flip):
    gen = torch.Generator(device=cuda).manual_seed(6)
    puv = torch.randn(graph.n_nodes, 128, device=cuda, generator=gen)
    be = torch.randn(graph.n_edges, 64, device=cuda, generator=gen)
    u, v, _, _ = graph.roles(flip)
    n0 = K.k6_score_gate.launches
    got = K.k6_score_gate(u, v, puv, be)
    assert K.k6_score_gate.launches == n0 + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, K.k6_score_gate_plain(u, v, puv, be),
                               rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs(graph, cuda):
    u, v, _, _ = graph.roles(False)
    puv = torch.zeros(graph.n_nodes, 128, device=cuda)
    with pytest.raises(TypeError):
        K.k6_score_gate(u, v, puv, torch.zeros(graph.n_edges, 64,
                                               device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        K.k6_score_gate(u, v, puv, torch.zeros(graph.n_edges + 1, 64,
                                               device=cuda))
