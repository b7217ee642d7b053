"""Inference pipeline: score edges on the GPU, decode contigs, emit FASTA.

The PyTorch counterpart of ``gnnome_tpu/infer.py`` (reference
``inference.py:364-501``): the same logits cache (``{idx}_predicts.npy``),
per-graph decode checkpoints, timing phases and ``peak_rss_mb``.  Scoring
runs the SymGatedGCN eval forward on ``compute.device`` (``cuda`` by
default: it raises when no GPU is present; ``cpu`` runs the kernels' plain
versions).  Decoding runs on the host through the C++ library.
"""
from __future__ import annotations

import os
import pickle
import resource

import numpy as np
import torch

from .config import Config, resolve_device
from .data.dataset import dataset_for
from .decode import decode_greedy, walks_to_contigs, save_assembly, quick_evaluation
from .decode.assembly import write_report
from .models import SymGatedGCN, edge_features, node_features
from .models.checkpoint import load_model_weights
from .models.convert import module_state_from_numpy
from .ops import DeviceGraph
from .utils.seed import set_seed
from .utils.timing import Timer


def load_model(params, state, cfg: Config, device) -> SymGatedGCN:
    """The eval-mode ``SymGatedGCN`` for ``cfg.model`` with the numpy
    pytree weights ``(params, state)``, on ``device``."""
    model = SymGatedGCN.from_config(cfg.model)
    model.load_state_dict(module_state_from_numpy(params, state))
    return model.to(device)


@torch.inference_mode()
def score_model(model: SymGatedGCN, graph, cfg: Config, device) -> np.ndarray:
    """Edge logits [E] (host edge order) of ``graph`` under ``model``."""
    g = DeviceGraph.from_graph(graph, device)
    x = torch.as_tensor(node_features(graph), device=device)
    e = torch.as_tensor(edge_features(graph, cfg.data.use_similarities),
                        device=device)
    return model(g, x, e).reshape(-1).cpu().numpy()


def score_graph(graph, params, state, cfg: Config | None = None) -> np.ndarray:
    """Edge logits [E] for a host graph with the numpy pytree weights, on
    ``cfg.compute.device``."""
    cfg = cfg or Config()
    device = resolve_device(cfg.compute.device)
    return score_model(load_model(params, state, cfg, device), graph, cfg,
                       device)


def run_inference(data_path: str, model_path: str, assembler: str,
                  savedir: str, cfg: Config | None = None,
                  verbose: bool = True) -> dict:
    """Full inference over every graph in a dataset directory
    (reference inference.py:364-501)."""
    cfg = cfg or Config()
    device = resolve_device(cfg.compute.device)
    rng_np, _ = set_seed(cfg.train.seed)
    timer = Timer()

    # cache=False: each graph is visited exactly once here
    ds = dataset_for(assembler, data_path, threads=cfg.decode.num_threads,
                     config=cfg, cache=False)
    decode_dir = os.path.join(savedir, "decode")
    checkpoint_dir = os.path.join(savedir, "checkpoint")
    assembly_dir = os.path.join(savedir, "assembly")
    for d in (decode_dir, checkpoint_dir, assembly_dir):
        os.makedirs(d, exist_ok=True)

    model = None
    summary = {"graphs": []}
    for idx, graph in ds:
        if verbose:
            print(f"==== Processing graph {idx} ==== "
                  f"(N={graph.num_nodes}, E={graph.num_edges})")

        predicts_path = os.path.join(decode_dir, f"{idx}_predicts.npy")
        with timer.phase("score"):
            if cfg.decode.decode_with_labels:
                if graph.y is None:
                    raise ValueError(
                        "decode_with_labels requires a graph parsed with "
                        "training=True (no GT labels present)")
                scores = np.asarray(graph.y, dtype=np.float32)
            elif cfg.decode.random_baseline:
                # an explicit baseline request beats the predicts cache
                scores = np.full(graph.num_edges, 10.0, dtype=np.float32)
            elif os.path.isfile(predicts_path):
                scores = np.load(predicts_path)
            else:
                if model is None:
                    params, state = load_model_weights(model_path)
                    model = load_model(params, state, cfg, device)
                scores = score_model(model, graph, cfg, device)
                np.save(predicts_path, scores)

        with timer.phase("decode"):
            # per-graph checkpoint name: graph i must never resume from
            # graph i-1's walks
            result = decode_greedy(graph, scores, cfg.decode,
                                   checkpoint_dir=checkpoint_dir, rng=rng_np,
                                   use_labels=cfg.decode.decode_with_labels,
                                   verbose=verbose,
                                   checkpoint_name=f"checkpoint_{idx}.pkl")
        with open(os.path.join(decode_dir, f"{idx}_walks.pkl"), "wb") as f:
            pickle.dump(result.walks, f)

        with timer.phase("assemble"):
            reads = ds.load_reads(idx)
            contigs = walks_to_contigs(result.walks, graph, reads)
            asm_path = save_assembly(contigs, assembly_dir, idx)

        ev = quick_evaluation(contigs)
        ev["assembly_path"] = asm_path
        ev["idx"] = idx
        summary["graphs"].append(ev)
        write_report(savedir, idx, ev)
        if verbose:
            print(f"graph {idx}: {ev}")

    summary["timing"] = dict(timer.phases)
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    summary["peak_rss_mb"] = rss_mb
    summary["device"] = str(device)
    if verbose:
        print(timer.summary())
        print(f"peak host memory: {rss_mb:.0f} MB")
    return summary
