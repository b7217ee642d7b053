"""Plain PyTorch reference of GNNome's SymGatedGCN (github.com/lbcb-sci/
GNNome: ``models/full_graph.py``, ``layers/gated_gcn_full.py``,
``layers/score_predictor.py``, the symmetry loss of ``train.py``), in
float32 with TF32 off, for the benchmark's check of ``correct``.

It imports nothing of the program.  It takes the inputs the benchmark
made (the graph's host arrays, the weights, the seed of the dropout
masks) and works out again what the program derives from them: the node
and edge features, the message passing (``index_add`` sums in host edge
order), the loss, the gradients and Adam's updates.

Departures from the published code, each to meet the program's
definition of the same thing: the edge BatchNorm of a layer normalises
once (the published layer applies ``bn_e`` twice to the same gate, with
the same result); dropout draws its masks with ``torch.rand`` from a
generator seeded by the benchmark, in the order the configuration's
``dropout_draws`` states; Adam adds eps outside the square root (as
``torch.optim.Adam`` and optax do).

``tf32=True`` computes every matrix product, forward and backward, with
both operands rounded to TF32 (10 mantissa bits, to nearest even) and
float32 sums: the control of the check.  Layers run under
``torch.utils.checkpoint`` in training, so the reference fits beside
what is left on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

GATE_EPS = 1e-6
NORM_EPS = 1e-5


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
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if tf32:
        return _TF32Linear.apply(x, w, b)
    return F.linear(x, w, b)


def _mlp2(P, a, b, x, tf32):
    return _linear(P, b, torch.relu(_linear(P, a, x, tf32)), tf32)


def _seg_sum(values, index, n):
    return values.new_zeros((n,) + values.shape[1:]).index_add(0, index,
                                                               values)


def _norm(P, name, x, kind, train):
    if kind == "none":
        return x
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if kind == "layer":
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
    elif train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    return (x - mean) * torch.rsqrt(var + NORM_EPS) * w + b


def _layer(P, cfg, i, u, v, n, train, tf32, h, e, mask):
    p = f"gnn.convs.{i}."
    kind = cfg["normalization"]
    a1, a2, a3, b1, b2 = (_linear(P, p + m, h, tf32)
                          for m in ("A_1", "A_2", "A_3", "B_1", "B_2"))
    b3e = _linear(P, p + "B_3", e, tf32)
    x = _norm(P, p + "bn_e", b1[u] + b2[v] + b3e, kind, train)
    e_new = torch.relu(x) + e
    s = torch.sigmoid(e_new)
    h_fwd = _seg_sum(s * a2[u], v, n) / (_seg_sum(s, v, n) + GATE_EPS)
    h_bwd = _seg_sum(s * a3[v], u, n) / (_seg_sum(s, u, n) + GATE_EPS)
    h_new = torch.relu(_norm(P, p + "bn_h", a1 + h_fwd + h_bwd, kind,
                             train)) + h
    if mask is not None:
        rate = cfg["dropout"]
        h_new = torch.where(mask, h_new / (1.0 - rate),
                            torch.zeros_like(h_new))
    return h_new, e_new


def _predictor(P, u, v, tf32, h, e):
    z = torch.relu(_linear(P, "predictor.W1",
                           torch.cat([h[u], h[v], e], dim=1), tf32))
    z = torch.relu(_linear(P, "predictor.W2", z, tf32))
    return _linear(P, "predictor.W3", z, tf32)[:, 0]


def zscore(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.float32)
    std = v.std() if v.numel() > 1 else v.new_ones(())
    return (v - v.mean()) / torch.where(std > 0, std, torch.ones_like(std))


class RefGraph:
    """A graph on the device in host edge order, with its features."""

    def __init__(self, graph, device):
        self.n = graph.num_nodes
        self.src = torch.as_tensor(graph.src, device=device).long()
        self.dst = torch.as_tensor(graph.dst, device=device).long()
        zi = zscore(torch.bincount(self.dst, minlength=self.n))
        zo = zscore(torch.bincount(self.src, minlength=self.n))
        self.x = torch.stack([zi, zo], 1)
        self.x_rev = torch.stack([zo, zi], 1)
        ol = torch.as_tensor(graph.overlap_length, device=device)
        sim = torch.as_tensor(graph.overlap_similarity, device=device)
        self.e = torch.stack([zscore(ol), sim.to(torch.float32)], 1)
        self.y = torch.as_tensor(graph.y, device=device)


def forward(P, cfg, g: RefGraph, flip: bool, train: bool = False,
            masks=None, tf32: bool = False, remat: bool = False):
    """Logits [E] of one pass (``flip``: the reversed graph, u = dst and
    v = src, on the reversed node features)."""
    u, v = (g.dst, g.src) if flip else (g.src, g.dst)
    h = _mlp2(P, "linear1_node", "linear2_node", g.x_rev if flip else g.x,
              tf32)
    e = _mlp2(P, "linear1_edge", "linear2_edge", g.e, tf32)
    for i in range(cfg["num_gnn_layers"]):
        mask = None if masks is None else masks[i]

        def run(h, e, mask, i=i):
            return _layer(P, cfg, i, u, v, g.n, train, tf32, h, e, mask)

        h, e = (checkpoint(run, h, e, mask, use_reentrant=False) if remat
                else run(h, e, mask))
    if remat:
        return checkpoint(_predictor, P, u, v, tf32, h, e,
                          use_reentrant=False)
    return _predictor(P, u, v, tf32, h, e)


@torch.no_grad()
def score(P, cfg, g: RefGraph, tf32: bool = False) -> torch.Tensor:
    """Eval-mode logits [E], host edge order."""
    return forward(P, cfg, g, False, tf32=tf32)


def _bce(logits, y, pos_weight):
    return -(pos_weight * y * F.logsigmoid(logits)
             + (1.0 - y) * F.logsigmoid(-logits))


def symmetry_loss(lo, lr, y, pos_weight, alpha):
    return (_bce(lo, y, pos_weight) + _bce(lr, y, pos_weight)
            + alpha * (lo - lr).abs()).mean()


def dropout_masks(cfg, n: int, gen, device):
    """One step's masks ``(org, flip)``, a list of [n, d] bools each, drawn
    from ``gen`` as the configuration's ``dropout_draws`` says: ``dual``,
    one [n, 2d] draw per layer (the org half first); ``pair``, the org
    pass's [n, d] draws, layer by layer, then the flip pass's."""
    d, layers, keep = cfg["dim_latent"], cfg["num_gnn_layers"], \
        1.0 - cfg["dropout"]

    def draw(width):
        return torch.rand((n, width), generator=gen, device=device,
                          dtype=torch.float32) < keep

    if cfg["dropout_draws"] == "dual":
        both = [draw(2 * d) for _ in range(layers)]
        return [m[:, :d] for m in both], [m[:, d:] for m in both]
    if cfg["dropout_draws"] == "pair":
        org = [draw(d) for _ in range(layers)]
        return org, [draw(d) for _ in range(layers)]
    raise ValueError(f"dropout_draws={cfg['dropout_draws']!r}")


def trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var",
                              "num_batches_tracked"))


def train_steps(P0: dict, cfg, g: RefGraph, pos_weight: float, gen,
                steps: int = 3, tf32: bool = False, edge_share: float = 1.0):
    """``steps`` symmetry-loss Adam steps from the weights ``P0``, dropout
    masks drawn from ``gen``.  Returns ``(losses, grad1, change)``: each
    step's loss, and per trainable tensor the norm of the first step's
    gradient and of the parameters' change over the steps (float64).
    ``edge_share`` < 1 takes the loss's mean over that leading share of
    the edges only (a planted fault)."""
    device = g.src.device
    P = {k: (t.clone().requires_grad_(True) if trainable(k) else t)
         for k, t in P0.items()}
    names = [k for k in P if trainable(k)]
    m = {k: torch.zeros_like(P[k]) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, cfg["lr"]
    k_edges = max(1, int(round(edge_share * g.src.shape[0])))
    losses, grad1 = [], {}
    for t in range(1, steps + 1):
        masks_o, masks_f = dropout_masks(cfg, g.n, gen, device)
        lo = forward(P, cfg, g, False, True, masks_o, tf32, remat=True)
        lr_ = forward(P, cfg, g, True, True, masks_f, tf32, remat=True)
        loss = symmetry_loss(lo[:k_edges], lr_[:k_edges], g.y[:k_edges],
                             pos_weight, cfg["alpha"])
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
        del lo, lr_, loss, grads
    change = {k: float((P[k].detach().double() - P0[k].double()).norm())
              for k in names}
    return losses, grad1, change


def set_float32():
    """float32 products in float32: TF32 off, as the configuration states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
