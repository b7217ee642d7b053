"""Train and eval steps + host-side example preparation (the PyTorch
counterpart of ``gnnome_tpu/train/step.py``).

* masking and partitioning happen on the host (numpy) exactly as in the JAX
  package (strandwise masking, reference train.py:91-100; clustering,
  train.py:335, via ``graphs/partition.py``), producing ``HostUnit``s;
* node degree features come from the pre-mask graph and are z-scored per
  unit (train.py:112-135); edge features are computed once on the full
  graph and gathered (utils/data_utils.py:34-40, train.py:134);
* a ``TrainExample`` holds a unit on the device: its ``DeviceGraph`` (and
  a zoo model's processor graph) and features, with edge features and
  labels already in slot order (no padding), so the step does no
  permutation on the device;
* the SymGatedGCN trains with the symmetry loss (train.py:159-185):
  with batch norm both passes run as one dual-width pass
  (``forward_dual``), with layer norm or none as two passes with chained
  state (``forward_pair``), as the JAX ``loss_fn`` does
  (step.py:254-276); the zoo models train with plain pos-weighted BCE in
  one ``flip=False`` pass (step.py:229-231).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config
from ..models.zoo import SYM_NAMES, processor_graph
from ..ops.graph_tensors import DeviceGraph
from .loss import bce_with_logits, symmetry_loss


@dataclass
class TrainExample:
    g: DeviceGraph
    x: torch.Tensor             # [N, 2] z-scored (in, out) degrees
    x_rev: torch.Tensor         # [N, 2] the reversed graph's: (out, in)
    e: torch.Tensor             # [E, F] edge features, slot order
    labels: torch.Tensor        # [E] float32, slot order
    labels_host: np.ndarray     # the same labels on the host
    g_proc: DeviceGraph | None = None   # a zoo model's processor graph


def _zscore(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.float32)
    std = v.std(ddof=1) if v.size > 1 else 1.0
    return (v - v.mean()) / (std if std > 0 else 1.0)


def make_example(in_deg, out_deg, e_feat, y, src, dst, n_nodes: int,
                 device, model_cfg=None) -> TrainExample:
    """Device example from host arrays (host edge order in, slot order
    out); with ``model_cfg`` naming a zoo model, also the processor graph
    that model runs on (``models.zoo.processor_graph``)."""
    g = DeviceGraph.build(src, dst, n_nodes, device)
    eid_of_slot = g.eid_of_slot.cpu().numpy()
    zi, zo = _zscore(in_deg), _zscore(out_deg)
    y_slots = np.asarray(y, dtype=np.float32)[eid_of_slot]
    return TrainExample(
        g=g,
        x=torch.as_tensor(np.stack([zi, zo], axis=1), device=device),
        x_rev=torch.as_tensor(np.stack([zo, zi], axis=1), device=device),
        e=torch.as_tensor(np.ascontiguousarray(e_feat[eid_of_slot],
                                               dtype=np.float32),
                          device=device),
        labels=torch.as_tensor(y_slots, device=device),
        labels_host=y_slots,
        g_proc=(None if model_cfg is None else
                processor_graph(model_cfg, src, dst, n_nodes, device)))


def mask_graph_strandwise(graph, fraction: float, rng: np.random.Generator):
    """Random strand-pair node subsampling (reference train.py:91-100).
    Returns (subgraph, orig_nodes, orig_edges)."""
    keep_half = rng.random(graph.num_nodes // 2) < fraction
    keep = np.repeat(keep_half, 2)
    return graph.node_subgraph(keep)


@dataclass
class HostUnit:
    """One host-side training unit (masked and/or clustered subgraph) before
    device layout: degree features from the pre-mask graph, z-scoring
    still pending."""
    in_deg: np.ndarray
    out_deg: np.ndarray
    e_feat: np.ndarray
    y: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    n_nodes: int


def host_units(graph, cfg: Config, rng: np.random.Generator,
               shuffle_parts: bool = True) -> list[HostUnit]:
    """Mask + (maybe) partition one dataset graph into host units
    (reference train.py:311-348)."""
    from ..graphs.partition import partition_graph
    from ..models.features import edge_features

    in_deg_full = graph.in_degrees()
    out_deg_full = graph.out_degrees()
    e_full = edge_features(graph, cfg.data.use_similarities)
    y_full = graph.y

    if cfg.train.masking:
        fraction = rng.integers(cfg.train.mask_frac_low,
                                cfg.train.mask_frac_high + 1) / 100
        sub, nid, eid = mask_graph_strandwise(graph, fraction, rng)
    else:
        sub, nid, eid = (graph, np.arange(graph.num_nodes),
                         np.arange(graph.num_edges))

    in_deg, out_deg = in_deg_full[nid], out_deg_full[nid]
    e_feat, y = e_full[eid], y_full[eid]

    if sub.num_nodes <= cfg.train.num_nodes_per_cluster:
        return [HostUnit(in_deg, out_deg, e_feat, y, sub.src, sub.dst,
                         sub.num_nodes)]

    num_clusters = sub.num_nodes // cfg.train.num_nodes_per_cluster + 1
    parts = partition_graph(sub, num_clusters, k_hops=cfg.train.k_extra_hops)
    if shuffle_parts:
        rng.shuffle(parts)
    return [HostUnit(in_deg[p.orig_nodes], out_deg[p.orig_nodes],
                     e_feat[p.orig_edges], y[p.orig_edges],
                     p.graph.src, p.graph.dst, p.graph.num_nodes)
            for p in parts]


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with the optax defaults (JAX ``make_optimizer``, step.py:214-216):
    betas 0.9 / 0.999, eps 1e-8 added outside the square root."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def _loss(model, ex: TrainExample, pos_weight: float, cfg: Config,
          generator):
    """(loss, org-pass logits [E] in slot order), as the JAX ``loss_fn``
    (step.py:254-276): the SymGatedGCN's symmetry loss over
    ``forward_dual`` (one dual-width pass with batch norm, two passes
    otherwise), or plain BCE of one ``flip=False`` pass (the zoo models,
    or the symmetry loss switched off)."""
    if cfg.model.model not in SYM_NAMES:
        lo = model(ex.g, ex.x, ex.e, ex.g_proc, generator, slot_io=True)
        return bce_with_logits(lo[:, 0], ex.labels, pos_weight), lo[:, 0]
    if cfg.train.use_symmetry_loss:
        lo, lr = model.forward_dual(ex.g, ex.x, ex.x_rev, ex.e, generator,
                                    slot_io=True)
        lo = lo[:, 0]
        return symmetry_loss(lo, lr[:, 0], ex.labels, pos_weight,
                             alpha=cfg.train.alpha), lo
    lo = model(ex.g, ex.x, ex.e, False, generator, slot_io=True)[:, 0]
    return bce_with_logits(lo, ex.labels, pos_weight), lo


def train_step(model, opt, ex: TrainExample, pos_weight: float, cfg: Config,
               generator):
    """One Adam step on one example (step.py:249-302): training-mode
    forward(s), loss, backward, update.  Returns ``(loss, logits)``
    as device tensors: no host synchronisation happens here."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss, logits = _loss(model, ex, pos_weight, cfg, generator)
    loss.backward()
    opt.step()
    return loss.detach(), logits.detach()


@torch.no_grad()
def eval_step(model, ex: TrainExample, pos_weight: float, cfg: Config):
    """Loss and logits with the eval forward (running statistics, no
    dropout), step.py:304-310."""
    model.eval()
    return _loss(model, ex, pos_weight, cfg, None)
