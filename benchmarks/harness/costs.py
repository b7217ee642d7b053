"""The yardstick's arithmetic: the card's peaks, each kernel's least bytes
and operations, and the matrix products a SymGatedGCN step or request
needs.

The kernel costs are a frozen copy of ``chip_smoke.py``'s ``bound`` (here
``bound_seconds``, in seconds) and its ``k1_cost``, ``k2_cost``,
``k3_cost`` and ``k8_cost``: each kernel's least bytes (every input read
once, every output written once) and its operations, from N, E and the
width.  The benchmark keeps its own copy so that a change to the program
cannot move the yardstick.

``step_flops`` and ``request_flops`` count the matrix products of the
model as published (GNNome's SymGatedGCN): the encoders (the edge
encoder once, its output serving both passes), per layer A1-A3 and B1-B2
on nodes and B3 on edges, the score predictor with its first product
split into node space (``W1 [h_u | h_v | e] = (h W1u)[u] + (h W1v)[v] +
e W1e``, the least form), per symmetry pass; the backward twice the
forward, less the input gradients of the two first encoder layers, which
nothing needs.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 and float64 peaks
# outside the tensor cores (the port runs float32 products with TF32 off)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12

F4 = I4 = 4          # bytes of a float32, an int32


def bound_seconds(nbytes: float, flops: float, flops64: float = 0.0) -> float:
    """Least time in seconds: the larger of bytes over the memory rate and
    the float32 plus float64 operations over their peak rates."""
    return max(nbytes / HBM_BYTES_PER_S,
               flops / F32_FLOPS_PER_S + flops64 / F64_FLOPS_PER_S)


# The kernels' least bytes and operations; ``es`` is the bytes of one row
# element.  Indices and row pointers are int32, float64 sums 8 bytes.
def k3_cost(N: int, E: int, d: int, es: int = F4):
    """K3, the fused edge stage: read proj_u/proj_v (used columns), b3e,
    e_in, bn, u/v indices, both row-pointer arrays and one slot
    permutation; write e_out and both [N, 2d] sums.  ~20 flops per (edge,
    feature)."""
    return (es * (2 * N * 2 * d + 3 * E * d + 4 * d + 2 * N * 2 * d)
            + I4 * (3 * E + 2 * (N + 1))), 20.0 * E * d, 0.0


def k8_cost(N: int, E: int, d: int, es: int = F4):
    """K8, the edge stage's adjoint: read d_sum_u/v, proj_u/v ([N, 2d]
    each), b3e, e_in, d_e_out, bn, u/v indices, both row-pointer arrays
    and one slot permutation; write x, d_eo, node_u/v ([N, 3d]) and [2d]
    f64.  About 49 float32 and 3 float64 operations per (edge,
    feature)."""
    return (es * (4 * N * 2 * d + 3 * E * d + 4 * d + 2 * E * d
                  + 2 * N * 3 * d) + 8 * 2 * d + I4 * (3 * E + 2 * (N + 1)),
            49.0 * E * d, 3.0 * E * d)


def k1_cost(N: int, E: int, d: int, es: int = F4):
    """K1, endpoint gathers and gate: read the used [N, 2d] halves of the
    projection, b3e, u/v indices; write [E, 3d]; two adds per (edge,
    feature)."""
    return (es * (2 * N * 2 * d + E * d + E * 3 * d) + I4 * 2 * E,
            2.0 * E * d, 0.0)


def k2_cost(N: int, E: int, Dp: int, es: int = F4):
    """K2, the two-sided aggregate: read both [E, Dp] payloads, both
    row-pointer arrays and one slot permutation; write the two float32
    [N, Dp] sums; one add per element."""
    return (es * 2 * E * Dp + F4 * 2 * N * Dp + I4 * (E + 2 * (N + 1)),
            2.0 * E * Dp, 0.0)


def linear_flops(rows: int, fan_in: int, fan_out: int) -> float:
    return 2.0 * rows * fan_in * fan_out


def forward_flops(cfg: dict, N: int, E: int, passes: int) -> dict:
    """The forward matrix products of one SymGatedGCN forward over
    ``passes`` symmetry passes, split into the encoders' first layers
    (``first``, whose input gradients nothing needs) and the rest."""
    d, ne = cfg["dim_latent"], cfg["hidden_ne_features"]
    H, H2 = cfg["hidden_edge_scores"], cfg["score_hidden_2"]
    first = passes * linear_flops(N, cfg["node_features"], ne)
    first += linear_flops(E, cfg["edge_features"], ne)   # e is shared
    rest = passes * linear_flops(N, ne, d) + linear_flops(E, ne, d)
    layer = 5 * linear_flops(N, d, d) + linear_flops(E, d, d)
    rest += passes * cfg["num_gnn_layers"] * layer
    predictor = (2 * linear_flops(N, d, H) + linear_flops(E, d, H)
                 + linear_flops(E, H, H2) + linear_flops(E, H2, 1))
    rest += passes * predictor
    return {"first": first, "rest": rest}


def step_flops(cfg: dict, N: int, E: int) -> float:
    """A symmetry-loss training step: forward over both passes, backward
    twice the forward but once for the encoders' first layers."""
    f = forward_flops(cfg, N, E, passes=2)
    return 2.0 * f["first"] + 3.0 * f["rest"]


def request_flops(cfg: dict, N: int, E: int) -> float:
    """An eval scoring request: one forward pass."""
    f = forward_flops(cfg, N, E, passes=1)
    return f["first"] + f["rest"]
