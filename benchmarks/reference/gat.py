"""Plain PyTorch reference of GNNome's GAT model (github.com/lbcb-sci/
GNNome: ``GATModel``, ``models/full_graph.py:78-97``; ``GAT_processor``,
``layers/processor.py:49-70``, on DGL 0.8's ``GATConv``;
``layers/score_predictor.py``), in float32 with TF32 off, for the
benchmark's check of ``correct``.

It imports nothing of the program, and nothing but ``torch``: what it
shares with the SymGatedGCN reference beside it
(``benchmarks/reference/symgatedgcn.py``: the graph's features, the
encoders' and predictor's linears, the TF32 rounding, the BCE) is a copy
of that file's code, so each reference stands alone.  From the inputs the
benchmark made (the graph's host arrays, the weights, the seed of the
dropout masks) it works out again what the program derives from them:
the processor graph (the graph's edges in host order, then one self-loop
a node, as ``dgl.add_self_loop``), each GATConv (``fc`` without bias;
per-head logits ``LeakyReLU(0.2)(el[src] + er[dst])`` with ``el = (feat *
attn_l).sum(-1)``; a softmax over each destination's in-edges; the
messages ``alpha * feat[src]`` summed into dst with ``index_add``; heads
concatenated, the output bias), ``proj`` back to d, relu after every
layer but the last; the encoders and the unpacked predictor on the
graph's own edges; the pos-weighted BCE, the gradients and Adam's updates.

Departures from the published code, each to meet the program's
definition of the same thing: dropout (DGL's ``feat_drop`` at each conv's
input) draws one [N, d] mask a layer, in layer order, with ``torch.rand``
from a generator seeded by the benchmark, as the program's
``models/nn.py`` ``dropout`` draws them; the softmax subtracts each
destination's largest logit without a gradient through it (the softmax
does not change under a shift, and DGL's ``edge_softmax`` backward uses
its output alone); the loss is plain BCE over the graph's edges, with no
symmetry term (the zoo trains so); Adam adds eps outside the square root
(as ``torch.optim.Adam`` does); the weights are the benchmark's draws, not
DGL's init.

``tf32=True`` computes every matrix product, forward and backward, with
both operands rounded to TF32 and float32 sums: the control of the check.
``RefGraph(..., self_loops=False)`` runs the processor on the graph
without its self-loops: a planted fault.  Layers run under
``torch.utils.checkpoint`` in training, so the reference fits beside what
is left on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_SLOPE = 0.2


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32: 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0xFFF)) & -8192
    return i.view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = _round_tf32(x), _round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return F.linear(xr, wr, b)

    @staticmethod
    def backward(ctx, dy):
        xr, wr = ctx.saved_tensors
        dyr = _round_tf32(dy)
        dx = (dyr @ wr).view(xr.shape)
        dw = dyr.reshape(-1, dy.shape[-1]).t() @ xr.reshape(-1, xr.shape[-1])
        return dx, dw, dy.reshape(-1, dy.shape[-1]).sum(0)


def _linear(P, name, x, tf32):
    """The linear ``name``; ``fc`` has no bias."""
    w, b = P[f"{name}.weight"], P.get(f"{name}.bias")
    if tf32:
        return _TF32Linear.apply(x, w, x.new_zeros(w.shape[0]) if b is None
                                 else b)
    return F.linear(x, w, b)


def _mlp2(P, a, b, x, tf32):
    return _linear(P, b, torch.relu(_linear(P, a, x, tf32)), tf32)


def zscore(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.float32)
    std = v.std() if v.numel() > 1 else v.new_ones(())
    return (v - v.mean()) / torch.where(std > 0, std, torch.ones_like(std))


class RefGraph:
    """A graph on the device in host edge order, with its features, and
    the processor graph ``psrc``/``pdst``: the edges, then a self-loop a
    node (none with ``self_loops=False``)."""

    def __init__(self, graph, device, self_loops: bool = True):
        self.n = graph.num_nodes
        self.src = torch.as_tensor(graph.src, device=device).long()
        self.dst = torch.as_tensor(graph.dst, device=device).long()
        zi = zscore(torch.bincount(self.dst, minlength=self.n))
        zo = zscore(torch.bincount(self.src, minlength=self.n))
        self.x = torch.stack([zi, zo], 1)
        ol = torch.as_tensor(graph.overlap_length, device=device)
        sim = torch.as_tensor(graph.overlap_similarity, device=device)
        self.e = torch.stack([zscore(ol), sim.to(torch.float32)], 1)
        self.y = torch.as_tensor(graph.y, device=device)
        self.psrc, self.pdst = self.src, self.dst
        if self_loops:
            loops = torch.arange(self.n, device=device)
            self.psrc = torch.cat([self.src, loops])
            self.pdst = torch.cat([self.dst, loops])


def _conv(P, cfg, i, g: RefGraph, h, mask, tf32):
    """One GATConv and its ``proj``: ``[N, d]``, before the relu."""
    p, heads, d = f"gnn.convs.{i}.", cfg["heads"], cfg["dim_latent"]
    n = h.shape[0]
    if mask is not None:
        h = torch.where(mask, h / (1.0 - cfg["dropout"]), torch.zeros_like(h))
    feat = _linear(P, p + "fc", h, tf32).view(n, heads, d)
    el = (feat * P[p + "attn_l"]).sum(-1)                  # [N, heads]
    er = (feat * P[p + "attn_r"]).sum(-1)
    s = F.leaky_relu(el[g.psrc] + er[g.pdst], NEG_SLOPE)   # [E', heads]
    idx = g.pdst[:, None].expand(-1, heads)
    with torch.no_grad():
        top = torch.full((n, heads), -torch.inf,
                         device=h.device).scatter_reduce(0, idx, s, "amax")
    ex = torch.exp(s - top[g.pdst])
    den = torch.zeros((n, heads), device=h.device).index_add(0, g.pdst, ex)
    alpha = ex / den[g.pdst]
    msg = (feat[g.psrc] * alpha[:, :, None]).reshape(-1, heads * d)
    out = torch.zeros((n, heads * d), device=h.device).index_add(
        0, g.pdst, msg) + P[p + "bias"]
    return _linear(P, f"proj.{i}", out, tf32)


def _predictor(P, u, v, tf32, h, e):
    z = torch.relu(_linear(P, "predictor.W1",
                           torch.cat([h[u], h[v], e], dim=1), tf32))
    z = torch.relu(_linear(P, "predictor.W2", z, tf32))
    return _linear(P, "predictor.W3", z, tf32)[:, 0]


def forward(P, cfg, g: RefGraph, masks=None, tf32: bool = False,
            remat: bool = False):
    """Logits [E] in host edge order; ``masks`` the [N, d] dropout masks
    of the layers (None: no dropout)."""
    h = _mlp2(P, "linear1_node", "linear2_node", g.x, tf32)
    e = _mlp2(P, "linear1_edge", "linear2_edge", g.e, tf32)
    layers = cfg["num_gnn_layers"]
    for i in range(layers):
        mask = None if masks is None else masks[i]

        def run(h, mask, i=i):
            out = _conv(P, cfg, i, g, h, mask, tf32)
            return torch.relu(out) if i < layers - 1 else out

        h = (checkpoint(run, h, mask, use_reentrant=False) if remat
             else run(h, mask))
    if remat:
        return checkpoint(_predictor, P, g.src, g.dst, tf32, h, e,
                          use_reentrant=False)
    return _predictor(P, g.src, g.dst, tf32, h, e)


def dropout_masks(cfg, n: int, gen, device) -> list:
    """One step's masks: an [n, d] bool a layer, in layer order."""
    keep = 1.0 - cfg["dropout"]
    return [torch.rand((n, cfg["dim_latent"]), generator=gen, device=device,
                       dtype=torch.float32) < keep
            for _ in range(cfg["num_gnn_layers"])]


def train_steps(P0: dict, cfg, g: RefGraph, pos_weight: float, gen,
                steps: int = 3, tf32: bool = False, edge_share: float = 1.0):
    """``steps`` Adam steps of the BCE loss from the weights ``P0``, dropout
    masks drawn from ``gen``.  Returns ``(losses, grad1, change)``: each
    step's loss, and per tensor the norm of the first step's gradient and
    of the parameters' change over the steps (float64).  ``edge_share`` <
    1 takes the loss's mean over that leading share of the edges only (a
    planted fault)."""
    if not cfg["directed"]:
        raise ValueError("the GAT reference runs the directed model only")
    device = g.src.device
    P = {k: t.clone().requires_grad_(True) for k, t in P0.items()}
    names = list(P)
    m = {k: torch.zeros_like(P[k]) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, cfg["lr"]
    k_edges = max(1, int(round(edge_share * g.src.shape[0])))
    losses, grad1 = [], {}
    for t in range(1, steps + 1):
        masks = dropout_masks(cfg, g.n, gen, device)
        lo = forward(P, cfg, g, masks, tf32, remat=True)
        y = g.y[:k_edges]
        loss = -(pos_weight * y * F.logsigmoid(lo[:k_edges])
                 + (1.0 - y) * F.logsigmoid(-lo[:k_edges])).mean()
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, gr in zip(names, grads):
                if t == 1:
                    grad1[k] = float(gr.double().norm())
                m[k].mul_(b1).add_(gr, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(gr, gr, value=1 - b2)
                step = (m[k] / (1 - b1 ** t)) / (
                    (v[k] / (1 - b2 ** t)).sqrt() + eps)
                P[k] = (P[k] - lr * step).requires_grad_(True)
        del lo, loss, grads
    change = {k: float((P[k].detach().double() - P0[k].double()).norm())
              for k in names}
    return losses, grad1, change


def set_float32():
    """float32 products in float32: TF32 off, as the configuration states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
