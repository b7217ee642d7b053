"""The yardstick's arithmetic for the GAT configuration: the one-sided K2
walk's least bytes and operations, and the matrix products a GAT training
step needs.  Kept beside ``costs.py`` (whose peaks and ``k2_cost`` it
uses) and, like it, apart from the program, so that a change to the
program cannot move the yardstick.

``gat_step_flops`` counts the model as published (GNNome's ``GATModel``):
the encoders, per layer ``fc`` (d to H d) and ``proj`` (H d to d) on the
nodes, the score predictor over the graph's edges in its least form (as
``costs.forward_flops`` splits it), one pass (the zoo trains without the
symmetry loss); the backward twice the forward, less the input gradients
of the two first encoder layers, which nothing needs.  The attention's
elementwise products (``el``, ``er``, the weighting of the messages) are
not matrix products and are not counted.
"""
from __future__ import annotations

from .costs import F4, I4, linear_flops


def k2_side_cost(N: int, E: int, D: int, perm: bool = True):
    """One side of K2's walk (``csr_row_sum``) over E slots into N nodes, D
    wide: read the float32 [E, D] payload once, the row pointers and, on
    the side whose slots are not in node order (``perm``: the src side),
    the slot permutation; write the float32 [N, D] sum once.  One add per
    element."""
    return (F4 * E * D + I4 * ((N + 1) + (E if perm else 0)) + F4 * N * D,
            float(E * D), 0.0)


def gat_forward_flops(cfg: dict, N: int, E: int) -> dict:
    """The forward matrix products of one GAT forward, split into the
    encoders' first layers (``first``) and the rest."""
    d, ne, heads = cfg["dim_latent"], cfg["hidden_ne_features"], cfg["heads"]
    H, H2 = cfg["hidden_edge_scores"], cfg["score_hidden_2"]
    first = (linear_flops(N, cfg["node_features"], ne)
             + linear_flops(E, cfg["edge_features"], ne))
    rest = linear_flops(N, ne, d) + linear_flops(E, ne, d)
    layer = linear_flops(N, d, heads * d) + linear_flops(N, heads * d, d)
    rest += cfg["num_gnn_layers"] * layer
    rest += (2 * linear_flops(N, d, H) + linear_flops(E, d, H)
             + linear_flops(E, H, H2) + linear_flops(E, H2, 1))
    return {"first": first, "rest": rest}


def gat_step_flops(cfg: dict, N: int, E: int) -> float:
    """A GAT training step: one forward, the backward twice the forward but
    once for the encoders' first layers."""
    f = gat_forward_flops(cfg, N, E)
    return 2.0 * f["first"] + 3.0 * f["rest"]
