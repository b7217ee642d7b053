"""The system under test: the port's objects, built from a configuration
file and the traffic's graphs through the port's own entry points
(``config.Config``, ``config.resolve_device``, the ``AssemblyGraph``
container, ``models.zoo.get_model``).  The drivers build these here and
call the port's steps and forwards themselves; nothing else of the
harness imports the port."""
from __future__ import annotations

import numpy as np


def port_config(c: dict):
    """The port's ``Config`` for the configuration file ``c``: its model
    sizes, its loss and optimiser, its compute dtype; the graph trained
    whole (no masking, one unit however large)."""
    from gnnome_tpu_torch.config import Config

    cfg = Config()
    for key in ("normalization", "dim_latent", "num_gnn_layers",
                "node_features", "edge_features", "hidden_ne_features",
                "hidden_edge_scores", "dropout"):
        setattr(cfg.model, key, c[key])
    cfg.model.model = c["model"]
    cfg.train.lr = c["lr"]
    cfg.train.alpha = c["alpha"]
    cfg.train.use_symmetry_loss = True
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 2 ** 62
    cfg.data.use_similarities = c["edge_features"] == 2
    cfg.compute.dtype = c["dtype"]
    return cfg


def device(name: str):
    """``resolve_device``: the card (or, in tests, the CPU), TF32 off."""
    from gnnome_tpu_torch.config import resolve_device

    return resolve_device(name)


def assembly_graph(g):
    """The port's container for a traffic graph (``graphgen.Graph``)."""
    from gnnome_tpu_torch.graphs.container import AssemblyGraph

    src = g.src.astype(np.int64)
    return AssemblyGraph(
        num_nodes=g.num_nodes, src=g.src, dst=g.dst,
        read_length=g.read_length,
        prefix_length=np.maximum(1, g.read_length[src] - g.overlap_length),
        overlap_length=g.overlap_length,
        overlap_similarity=g.overlap_similarity, y=g.y)


def model(cfg, weights: dict, dev):
    """The configuration's model on ``dev`` with the benchmark's weights."""
    from gnnome_tpu_torch.models.zoo import get_model

    m = get_model(cfg.model).to(dev)
    m.load_state_dict(weights, strict=True)
    return m


def compute_dtype(cfg):
    from gnnome_tpu_torch.config import compute_dtype as dt

    return dt(cfg)
