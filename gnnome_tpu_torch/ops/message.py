"""Message-passing ops of the SymGatedGCN eval path, over a ``DeviceGraph``.

The PyTorch counterparts of ``gnnome_tpu/ops/message.py``'s
``fused_eval_edge_stage`` and ``fused_score_gate``: they resolve the endpoint
roles (``flip=True`` is the reversed-graph pass: u = dst, v = src, as in
message.py:325,690) and call the K3 / K6 kernel wrappers.  Edge arrays are
unpacked ``[E, d]`` in slot order: no padding, no overflow patching.
"""
from __future__ import annotations

from .graph_tensors import DeviceGraph
from .kernels import k3_edge_stage, k6_score_gate


def eval_edge_stage(g: DeviceGraph, proj_u, proj_v, b3e, e_in, bn,
                    flip: bool = False):
    """Eval-mode edge stage (K3): ``(e_out [E, d], sum_v [N, 2d],
    sum_u [N, 2d])`` where ``sum_v[i] = sum over edges with v = i of
    [sigma * A2h[u] | sigma]`` and ``sum_u`` likewise by u with A3h[v].
    ``proj_u`` = [B1h | A2h], ``proj_v`` = [B2h | A3h]; ``bn`` [4, d] the eval
    BatchNorm rows [mean, rsqrt(var + eps), weight, bias]
    (``models/norm.batch_norm_rows``; an affine ``x * a + b`` is
    ``[0, 1, a, b]``)."""
    u_idx, v_idx, v_csr, u_csr = g.roles(flip)
    return k3_edge_stage(u_idx, v_idx, v_csr, u_csr, proj_u, proj_v, b3e,
                         e_in, bn)


def score_gate(g: DeviceGraph, flip: bool, puv, be):
    """First score-predictor layer (K6): ``relu(pu[u] + pv[v] + be)`` with
    ``puv`` = [h @ W1u | h @ W1v] ([N, 2H]) and ``be`` = e @ W1e + b1."""
    u_idx, v_idx, _, _ = g.roles(flip)
    return k6_score_gate(u_idx, v_idx, puv, be)
