"""A GATConv after its ``fc`` (``models.zoo.gat_conv``: the kernels of
csrc/gat_edge.cu around the layer's six one-sided K2 walks) on the CPU,
where the wrappers run their plain versions.

Held against the PyTorch chain the layer ran before them (``_chain`` below:
row gathers, LeakyReLU, ``scatter_reduce``'s max, ``exp``, the
denominators' walk, gather, clamp and division, the gathered and weighted
``feat[src]``, the messages' walk, the bias; autograd's backward): one
layer's output and the gradients of its input, ``fc``, ``attn_l``,
``attn_r`` (through ``el`` / ``er``) and the bias, and a whole model's
logits and every gradient (``proj`` too), on three graphs: a synthetic
assembly graph with a self-loop a node, a graph with a hub of 2,500
in-edges, and the same assembly graph without self-loops and without the
edges into its first five nodes, which keep max 0. The forward repeats the
chain's operations: bit for bit; the backward adds the same terms, with
autograd's accumulation of ``feat``'s three gradients in its own order:
within ``rtol=1e-6, atol=1e-7``. The whole thing under ``gradcheck`` in
float64; under ``saved_tensors_hooks`` a layer saves no tensor of E' rows
and more than H columns (the chain saved the gathered ``feat[src]``), and
nothing under ``no_grad``. Each kernel's plain version against a loop over
the slots in float64, within float32 rounding (``rtol=1e-5, atol=1e-6``;
sums of many terms that cancel within 1e-5 of their magnitudes); the node
kernels' against a loop over the nodes. The CUDA kernels are held against
these plain versions by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gnnome_tpu_torch.config import ModelConfig
from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.models import get_model
from gnnome_tpu_torch.models.zoo import _GATConv, gat_conv, processor_graph
from gnnome_tpu_torch.ops import DeviceGraph, gather_rows, sum_into
from gnnome_tpu_torch.ops import kernels as K
from torch_recipes import gat_graph, gat_hub_graph

HEADS, D = 3, 16
GRAD_TOL = dict(rtol=1e-6, atol=1e-7)
LOOP_TOL = dict(rtol=1e-5, atol=1e-6)


def _chain(conv, g, h):
    """``_GATConv.forward`` as the PyTorch chain it was, dropout 0."""
    n, d = h.shape
    heads = conv.heads
    feat = conv.fc(h)
    f3 = feat.view(n, heads, d)
    el = (f3 * conv.attn_l).sum(-1)
    er = (f3 * conv.attn_r).sum(-1)
    logit = F.leaky_relu(gather_rows(g, "src", el)
                         + gather_rows(g, "dst", er), 0.2)
    with torch.no_grad():
        idx = g.dst.long()[:, None].expand(-1, heads)
        seg_max = logit.new_zeros(n, heads).scatter_reduce(
            0, idx, logit, "amax", include_self=False)
    expv = torch.exp(logit - seg_max.index_select(0, g.dst))
    denom = sum_into(g, "dst", expv)
    alpha = expv / gather_rows(g, "dst", denom).clamp_min(1e-9)
    msg = gather_rows(g, "src", feat).view(-1, heads, d) * alpha[:, :, None]
    return sum_into(g, "dst", msg.reshape(-1, heads * d)) + conv.bias


def _assembly():
    g, _, _, _ = synthetic_assembly_graph(n_reads=150, genome_len=12000,
                                          read_len=400, seed=30,
                                          false_edge_frac=0.1)
    return g


def _graph(which):
    """``(DeviceGraph, its nodes without an in-edge)``."""
    if which == "hub":
        g = gat_hub_graph()
    else:
        ag = _assembly()
        if which == "loops":
            g = gat_graph(ag.src, ag.dst, ag.num_nodes)
        else:       # the edges alone, those into nodes 0-4 left out
            keep = ag.dst >= 5
            g = DeviceGraph.build(ag.src[keep], ag.dst[keep], ag.num_nodes)
    deg = (g.dst_ptr[1:] - g.dst_ptr[:-1]).numpy()
    return g, np.nonzero(deg == 0)[0]


GRAPHS = ["loops", "hub", "no_loops"]


@pytest.fixture(scope="module", params=GRAPHS)
def graph(request):
    g, lonely = _graph(request.param)
    assert (len(lonely) > 0) == (request.param == "no_loops")
    return g


def _layer(seed):
    conv = _GATConv(D, HEADS)
    gen = torch.Generator().manual_seed(seed)
    conv.init_weights(gen)
    with torch.no_grad():
        conv.bias.normal_(0, 0.1, generator=gen)
    return conv


def _grads(conv, g, h, forward):
    h = h.clone().requires_grad_()
    conv.zero_grad()
    out = forward(conv, g, h)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(8))
    (out * w).sum().backward()
    return out.detach(), {"h": h.grad, **{n: p.grad.clone() for n, p in
                                          conv.named_parameters()}}


def test_layer_vs_the_chain(graph):
    """One layer's output bit for bit, and the gradients of its input,
    ``fc``, ``attn_l``, ``attn_r`` and the bias."""
    conv = _layer(1)
    h = torch.randn(graph.n_nodes, D,
                    generator=torch.Generator().manual_seed(2))
    got, g_got = _grads(conv, graph, h, lambda c, g, x: c(g, x, 0.0, None))
    want, g_want = _grads(conv, graph, h, _chain)
    assert torch.equal(got, want)
    assert g_got.keys() == {"h", "fc.weight", "attn_l", "attn_r", "bias"}
    for k in g_got:
        torch.testing.assert_close(g_got[k], g_want[k], **GRAD_TOL, msg=k)


def test_model_vs_the_chain(monkeypatch):
    """A 3-layer GAT on the assembly graph: the logits bit for bit and
    every parameter's gradient (encoders, ``fc``, attention, bias,
    ``proj``, predictor)."""
    ag = _assembly()
    cfg = ModelConfig(model="gat", num_gnn_layers=3, dim_latent=D,
                      hidden_edge_scores=D, dropout=0.0)
    model = get_model(cfg).init_weights(3).train()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(ag.num_nodes, 2)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(ag.num_edges, 2)).astype(np.float32))
    args = (DeviceGraph.from_graph(ag), x, e,
            processor_graph(cfg, ag.src, ag.dst, ag.num_nodes))

    def run():
        model.zero_grad()
        logits = model(*args)
        (logits.square().mean() + logits.mean()).backward()
        return logits.detach(), {n: p.grad.clone()
                                 for n, p in model.named_parameters()}

    got, g_got = run()
    monkeypatch.setattr(_GATConv, "forward",
                        lambda c, g, h, drop, gen: _chain(c, g, h))
    want, g_want = run()
    assert torch.equal(got, want)
    assert any(k.startswith("proj.") for k in g_got)
    for k in g_want:
        torch.testing.assert_close(g_got[k], g_want[k], **GRAD_TOL, msg=k)


def test_gradcheck_float64():
    """``gat_conv`` under ``gradcheck`` (2 heads of 3): the softmax does
    not change under the max's shift, so leaving the max's gradient out is
    exact."""
    src = np.array([0, 2, 2, 1, 3, 0, 4, 2, 1])
    dst = np.array([1, 1, 0, 3, 3, 2, 2, 4, 1])
    g = DeviceGraph.build(src, dst, 6)             # node 5: no edges
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(*s, generator=gen, dtype=torch.float64)
            for s in ((6, 2 * 3), (2, 3), (2, 3), (2 * 3,))]
    assert torch.autograd.gradcheck(
        lambda *a: gat_conv(g, *a), tuple(t.requires_grad_() for t in args))


def test_nothing_edge_wide_saved(graph):
    """Under ``saved_tensors_hooks`` a layer's forward saves no tensor of
    E' rows and more than H columns (the chain saved ``feat[src]``, E' x H
    d); under ``no_grad`` it saves nothing."""
    conv = _layer(1)
    h = torch.randn(graph.n_nodes, D,
                    generator=torch.Generator().manual_seed(2),
                    requires_grad=True)

    def saved(forward):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            forward(conv, graph, h)
        return shapes

    def wide(shapes):
        return [s for s in shapes if len(s) >= 2 and s[0] == graph.n_edges
                and np.prod(s[1:]) > HEADS]

    assert graph.n_edges != graph.n_nodes
    assert wide(saved(_chain)) == [(graph.n_edges, HEADS, D)]
    new = saved(lambda c, g, x: c(g, x, 0.0, None))
    assert new and wide(new) == []
    with torch.no_grad():
        assert saved(lambda c, g, x: c(g, x, 0.0, None)) == []


# ------------------------------------------------------------ plain versions
def _inputs(g, seed, d=D):
    gen = torch.Generator().manual_seed(seed)
    n, E = g.n_nodes, g.n_edges

    def randn(*s):
        return torch.randn(*s, generator=gen)

    return dict(el=randn(n, HEADS), er=randn(n, HEADS),
                feat=randn(n, HEADS * d), expv=torch.rand(E, HEADS,
                                                          generator=gen),
                denom=torch.rand(n, HEADS, generator=gen) * 4,
                d_out=randn(n, HEADS * d), d_expv=randn(E, HEADS),
                d_denom=randn(n, HEADS))


def _np(t):
    return t.detach().double().numpy()


def test_node_plain_versions_vs_loops():
    """The node kernels' plain versions against loops over the nodes and
    heads (float64)."""
    gen = torch.Generator().manual_seed(6)
    n = 50
    feat, acc = torch.randn(n, HEADS * D, generator=gen), torch.randn(
        n, HEADS * D, generator=gen)
    attn_l, attn_r = (torch.randn(HEADS, D, generator=gen) for _ in "lr")
    d_el, d_er = (torch.randn(n, HEADS, generator=gen) for _ in "lr")
    f, al, ar = _np(feat).reshape(n, HEADS, D), _np(attn_l), _np(attn_r)
    el, er = K.gat_node_logits_plain(feat, attn_l, attn_r)
    gl, gr = _np(d_el), _np(d_er)
    d_feat = _np(acc).reshape(n, HEADS, D).copy()
    d_attn = np.zeros((2, HEADS, D))
    for i in range(n):
        for h in range(HEADS):
            np.testing.assert_allclose(float(el[i, h]), f[i, h] @ al[h],
                                       **LOOP_TOL)
            np.testing.assert_allclose(float(er[i, h]), f[i, h] @ ar[h],
                                       **LOOP_TOL)
            d_feat[i, h] += gl[i, h] * al[h] + gr[i, h] * ar[h]
            d_attn[0, h] += gl[i, h] * f[i, h]
            d_attn[1, h] += gr[i, h] * f[i, h]
    got = K.gat_node_adjoint_plain(feat, attn_l, attn_r, d_el, d_er, acc)
    np.testing.assert_allclose(_np(got[0]), d_feat.reshape(n, -1),
                               **LOOP_TOL)
    np.testing.assert_allclose(_np(got[1]), d_attn, rtol=1e-5, atol=1e-5)


def test_plain_versions_vs_loops(graph):
    """The four edge kernels' plain versions against a loop over the slots
    (float64)."""
    a = _inputs(graph, 3)
    # denominators at the clamp: one node's sums below 1e-9 and at 0
    a["denom"][int(graph.dst[0])] = torch.tensor([0.0, 5e-10, 1e-9])
    src, dst = graph.src.long().numpy(), graph.dst.long().numpy()
    el, er, feat = _np(a["el"]), _np(a["er"]), _np(a["feat"])
    n, E = graph.n_nodes, graph.n_edges
    x = np.empty((E, HEADS))
    m = np.zeros((n, HEADS))
    seen = np.zeros(n, bool)
    for s in range(E):
        x[s] = el[src[s]] + er[dst[s]]
        x[s] = np.where(x[s] > 0, x[s], 0.2 * x[s])
        v = dst[s]
        m[v] = x[s] if not seen[v] else np.maximum(m[v], x[s])
        seen[v] = True
    want = np.exp(x - m[dst])
    got = K.gat_edge_softmax_plain(graph.src, graph.dst, a["el"], a["er"])
    np.testing.assert_allclose(_np(got), want, **LOOP_TOL)

    expv, den, d_out = _np(a["expv"]), _np(a["denom"]), _np(a["d_out"])
    alpha = np.empty((E, HEADS))
    msg = np.empty((E, HEADS * D))
    d_rows = np.empty((E, HEADS * D))
    d_ex = np.empty((E, HEADS))
    pay = np.empty((E, HEADS))
    mag = np.empty((E, HEADS))          # |d_expv|'s scale: sum of |terms|
    for s in range(E):
        u, v = src[s], dst[s]
        dc = np.maximum(den[v], 1e-9)
        alpha[s] = expv[s] / dc
        for h in range(HEADS):
            cols = slice(h * D, (h + 1) * D)
            msg[s, cols] = alpha[s, h] * feat[u, cols]
            d_rows[s, cols] = alpha[s, h] * d_out[v, cols]
            d_alpha = d_out[v, cols] @ feat[u, cols]
            mag[s, h] = np.abs(d_out[v, cols]) @ np.abs(feat[u, cols]) / dc[h]
            d_ex[s, h] = d_alpha / dc[h]
            pay[s, h] = (-d_alpha * alpha[s, h] / dc[h]
                         if den[v, h] >= np.float32(1e-9) else 0.0)
    got_msg, got_alpha = K.gat_messages_plain(graph.src, graph.dst,
                                              a["feat"], a["expv"],
                                              a["denom"])
    np.testing.assert_allclose(_np(got_msg), msg, **LOOP_TOL)
    np.testing.assert_allclose(_np(got_alpha), alpha, **LOOP_TOL)
    got = K.gat_message_adjoint_plain(graph.src, graph.dst, a["d_out"],
                                      a["feat"], got_alpha, a["denom"])
    np.testing.assert_allclose(_np(got[0]), d_rows, **LOOP_TOL)
    # d_alpha's sum cancels: within float32 rounding of its terms
    for t, w, scale in ((got[1], d_ex, mag), (got[2], pay, mag * alpha)):
        assert (np.abs(_np(t) - w) <= 1e-5 * scale + 1e-6).all()

    d_den = _np(a["d_denom"])
    dx = np.empty((E, HEADS))
    for s in range(E):
        pre = el[src[s]] + er[dst[s]]
        de = (_np(a["d_expv"])[s] + d_den[dst[s]]) * expv[s]
        dx[s] = np.where(pre > 0, de, 0.2 * de)
    got = K.gat_logit_adjoint_plain(graph.src, graph.dst, a["el"], a["er"],
                                    a["expv"], a["d_expv"], a["d_denom"])
    np.testing.assert_allclose(_np(got), dx, **LOOP_TOL)


def test_cpu_wrappers_take_the_plain_versions(graph):
    """On the CPU each of the six wrappers returns its plain version's
    result and counts no launch."""
    a = _inputs(graph, 4)
    s, t = graph.src, graph.dst
    attn = torch.randn(2, HEADS, D, generator=torch.Generator().manual_seed(1))
    K.reset_launch_counts()
    pairs = [
        (K.gat_node_logits(a["feat"], *attn),
         K.gat_node_logits_plain(a["feat"], *attn)),
        (K.gat_node_adjoint(a["feat"], *attn, a["el"], a["er"], a["d_out"]),
         K.gat_node_adjoint_plain(a["feat"], *attn, a["el"], a["er"],
                                  a["d_out"])),
        (K.gat_edge_softmax(s, t, graph.dst_ptr, a["el"], a["er"]),
         K.gat_edge_softmax_plain(s, t, a["el"], a["er"])),
        (K.gat_messages(s, t, a["feat"], a["expv"], a["denom"]),
         K.gat_messages_plain(s, t, a["feat"], a["expv"], a["denom"])),
        (K.gat_message_adjoint(s, t, a["d_out"], a["feat"], a["expv"],
                               a["denom"]),
         K.gat_message_adjoint_plain(s, t, a["d_out"], a["feat"], a["expv"],
                                     a["denom"])),
        (K.gat_logit_adjoint(s, t, a["el"], a["er"], a["expv"], a["d_expv"],
                             a["d_denom"]),
         K.gat_logit_adjoint_plain(s, t, a["el"], a["er"], a["expv"],
                                   a["d_expv"], a["d_denom"]))]
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert K.launch_counts() == {k: 0 for k in K.KERNELS}
