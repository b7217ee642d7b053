"""Input featurisation (host-side, numpy).

Reproduces the reference's feature pipeline:

* edge features ``e = [z(overlap_length), overlap_similarity]`` with the
  z-score over the graph using the *unbiased* std (torch ``.std()``,
  reference utils/data_utils.py:34-40);
* node features ``x = [z(in_deg), z(out_deg)]`` (reference train.py:112-122,
  inference.py:414-420); the reversed-graph pass swaps the two columns
  (train.py:117-118).
"""
from __future__ import annotations

import numpy as np


def _zscore(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.float32)
    std = v.std(ddof=1) if v.size > 1 else 1.0
    return (v - v.mean()) / (std if std > 0 else 1.0)


def edge_features(graph, use_similarities: bool = True) -> np.ndarray:
    ol = _zscore(graph.overlap_length)
    if use_similarities:
        if graph.overlap_similarity is None:
            raise ValueError("graph has no overlap_similarity; parse with "
                             "get_similarities=True or set use_similarities=False")
        return np.stack([ol, graph.overlap_similarity.astype(np.float32)], axis=1)
    return ol[:, None]


def node_features(graph, reverse: bool = False) -> np.ndarray:
    pe_in = _zscore(graph.in_degrees())
    pe_out = _zscore(graph.out_degrees())
    if reverse:
        return np.stack([pe_out, pe_in], axis=1)
    return np.stack([pe_in, pe_out], axis=1)


def positional_encoding(graph, dim: int, kind: str = "RW") -> np.ndarray:
    """k-step random-walk / PageRank positional encodings.

    Port of the reference's dormant PE machinery (utils/data_utils.py:59-90,
    disabled by ``nb_pos_enc=0``, hyperparameters.py:26) so the capability is
    available; returns [N, dim] float32.
    """
    from scipy import sparse as sp

    n = graph.num_nodes
    A = sp.csr_matrix((np.ones(graph.num_edges, dtype=np.float64),
                       (graph.src.astype(np.int64), graph.dst.astype(np.int64))),
                      shape=(n, n))
    if kind == "RW":
        dinv = sp.diags(np.clip(graph.in_degrees().astype(np.float64), 1, None)
                        ** -1.0)
        M = A @ dinv
        pe = [M.diagonal()]
        m_power = M
        for _ in range(dim - 1):
            m_power = m_power @ M
            pe.append(m_power.diagonal())
        return np.stack(pe, axis=-1).astype(np.float32)
    if kind == "PR":
        d = np.asarray(A.sum(axis=1)).ravel()
        dinv = 1.0 / (d + 1e-9)
        dinv[d < 1e-9] = 0.0
        P = (sp.diags(dinv) @ A).T
        one = np.ones(n)
        x = one / n
        alpha = 0.95
        pe = []
        for _ in range(dim):
            x = alpha * P.dot(x) + (1.0 - alpha) / n * one
            pe.append(x.copy())
        return np.stack(pe, axis=-1).astype(np.float32)
    raise ValueError(f"Unknown positional encoding kind: {kind}")
