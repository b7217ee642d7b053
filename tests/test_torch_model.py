"""gnnome_tpu_torch SymGatedGCN (eval, CPU = the kernels' plain versions)
against the JAX package's forward, with the same numpy inputs and weights.

Tolerances are those of the torch-oracle parity tests
(tests/test_model_parity.py:76): ``atol=2e-5, rtol=1e-4`` on logits,
``atol=1e-5`` on probabilities.
"""
import os

import jax
import numpy as np
import pytest
import torch

from gnnome_tpu.config import ModelConfig as JaxModelConfig
from gnnome_tpu.graphs import synthetic_assembly_graph
from gnnome_tpu.graphs.container import AssemblyGraph
from gnnome_tpu.models import edge_features, node_features
from gnnome_tpu.models.sym_gated_gcn import forward, init_params
from gnnome_tpu.ops import GraphTensors
from gnnome_tpu.ops.graph_tensors import with_windowed_plans
from gnnome_tpu.ops.pallas_kernels import set_interpret

from gnnome_tpu_torch.config import ModelConfig
from gnnome_tpu_torch.models import (SymGatedGCN, load_model_weights,
                                     module_state_from_numpy,
                                     numpy_from_module_state)
from gnnome_tpu_torch.ops import DeviceGraph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "weights.npz")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_ecoli_v1.npz")
LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)


def _port_logits(params, state, cfg_kw, g, x, e, flip=False):
    model = SymGatedGCN.from_config(ModelConfig(**cfg_kw))
    model.load_state_dict(module_state_from_numpy(params, state))
    with torch.inference_mode():
        lo = model(DeviceGraph.from_graph(g), torch.from_numpy(x),
                   torch.from_numpy(e), flip=flip)
    return lo.numpy()[:, 0]


def _jax_logits(params, state, cfg_kw, gt, g, x, e, flip, backend):
    lo, _ = forward(params, state, gt, gt.pad_nodes(x), gt.pad_edges(e),
                    JaxModelConfig(**cfg_kw), training=False, flip=flip,
                    backend=backend)
    return np.asarray(lo)[: g.num_edges, 0]


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ random weights
SMALL = dict(num_gnn_layers=3, dim_latent=16, hidden_edge_scores=16,
             dropout=0.0)


@pytest.fixture(scope="module")
def small():
    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=20000,
                                          read_len=400, seed=70,
                                          with_sequences=True,
                                          false_edge_frac=0.15)
    params, state = _to_numpy(init_params(jax.random.PRNGKey(4),
                                          JaxModelConfig(**SMALL)))
    # non-trivial BN running statistics, from numpy
    rng = np.random.default_rng(0)
    for bn in ("bn_h", "bn_e"):
        s = state["gnn"][bn]
        s["mean"] = rng.normal(0, 0.3, s["mean"].shape).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
    gt = GraphTensors.from_graph(g, 128, 128)
    return g, params, state, gt


@pytest.mark.parametrize("flip", [False, True])
def test_random_weights_vs_jax_xla(small, flip):
    g, params, state, gt = small
    x, e = node_features(g, reverse=flip), edge_features(g)
    ref = _jax_logits(params, state, SMALL, gt, g, x, e, flip, "xla")
    got = _port_logits(params, state, SMALL, g, x, e, flip)
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


@pytest.mark.parametrize("flip", [False, True])
def test_random_weights_vs_jax_pallas_interpret(small, flip):
    g, params, state, gt = small
    gt_w = with_windowed_plans(gt, flip_too=True, tile_e=128, window=128)
    x, e = node_features(g, reverse=flip), edge_features(g)
    set_interpret(True)
    try:
        ref = _jax_logits(params, state, SMALL, gt_w, g, x, e, flip,
                          "pallas")
    finally:
        set_interpret(False)
    got = _port_logits(params, state, SMALL, g, x, e, flip)
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


# ----------------------------------------------------------- shipped weights
@pytest.fixture(scope="module")
def golden_sub():
    """The golden-subgraph recipe of tests/test_golden_cached.py:25-44: the
    band around node 0 plus bands around a few hard negatives."""
    g = AssemblyGraph.load(FIXTURE)
    hard = np.nonzero((g.y == 0) & (g.overlap_similarity > 0.95))[0]
    keep = np.zeros(g.num_nodes, dtype=bool)
    keep[:1600] = True
    band = 400
    for eid in hard[:: max(1, len(hard) // 4)][:4]:
        for v in (int(g.src[eid]), int(g.dst[eid])):
            keep[max(0, v - band): v + band] = True
    sub, _, _ = g.node_subgraph(keep)
    assert sub.num_edges > 10_000
    return sub


@pytest.mark.parametrize("flip", [False, True])
def test_shipped_weights_golden_subgraph_vs_jax_xla(golden_sub, flip):
    g = golden_sub
    params, state = load_model_weights(WEIGHTS)
    x, e = node_features(g, reverse=flip), edge_features(g)
    ref = _jax_logits(params, state, {}, GraphTensors.from_graph(g), g, x, e,
                      flip, "xla")
    got = _port_logits(params, state, {}, g, x, e, flip)
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a.astype(np.float64)))  # noqa: E731
    np.testing.assert_allclose(sig(got), sig(ref), atol=1e-5)


def test_npz_module_npz_roundtrip_bit_exact():
    params, state = load_model_weights(WEIGHTS)
    model = SymGatedGCN()
    model.load_state_dict(module_state_from_numpy(params, state))
    p2, s2 = numpy_from_module_state(model.state_dict())
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    a, b = flat({"p": params, "s": state}), flat({"p": p2, "s": s2})
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    # 218,465 parameters + 2,064 BatchNorm buffer elements (SURVEY.md §6)
    assert sum(t.numel() for t in model.state_dict().values()) == 220_529


def test_two_cpu_forwards_bitwise_equal(small):
    g, params, state, _ = small
    x, e = node_features(g), edge_features(g)
    a = _port_logits(params, state, SMALL, g, x, e)
    b = _port_logits(params, state, SMALL, g, x, e)
    assert np.array_equal(a, b)


def test_training_forward_refused():
    model = SymGatedGCN(num_layers=1).train()
    with pytest.raises(NotImplementedError):
        model(None, None, None)
