"""Inference pipeline: score edges on the GPU, decode contigs, emit FASTA.

The PyTorch counterpart of ``gnnome_tpu/infer.py`` (reference
``inference.py:364-501``): the same logits cache (``{idx}_predicts.npy``),
per-graph decode checkpoints, timing phases and ``peak_rss_mb``.  Scoring
runs the eval forward of the model ``model.model`` names (the SymGatedGCN
or a zoo model, on its processor graph) on ``compute.device`` (``cuda`` by
default: it raises when no GPU is present; ``cpu`` runs the kernels' plain
versions).  Decoding runs on the host through the C++ library.

With ``compute.mesh = P > 1`` scoring runs over P ranks (the counterpart
of ``gnnome_tpu/infer.py:65-77``): the batch-norm SymGatedGCN on the halo
path (``parallel/halo.py``), every other model on the sharded path
(``parallel/sharded.py``, in float32).  ``run_inference`` and
``score_graph`` started outside a group spawn the ranks
(``parallel.group.run``), or, in a process a launcher started (a
launcher per host, ``compute.mesh`` its ``WORLD_SIZE``), join the
launcher's group; every rank scores its shard of each graph whose logits
rank 0 finds no cache for (rank 0 decides: the hosts' disks may differ),
rank 0 gathers them, writes the cache, decodes and writes the FASTA, and
its summary is the call's.  No path falls back to one device.
"""
from __future__ import annotations

import os
import pickle
import resource

import numpy as np
import torch

from .config import Config, check_compute, compute_dtype, resolve_device
from .data.dataset import dataset_for
from .decode import decode_greedy, walks_to_contigs, save_assembly, quick_evaluation
from .decode.assembly import write_report
from .models import edge_features, node_features
from .models.checkpoint import load_model_weights
from .models.convert import load_model_pytrees
from .models.zoo import SYM_NAMES, get_model, processor_graph
from .ops import DeviceGraph
from .utils.seed import set_seed
from .utils.timing import Timer, span


def load_model(params, state, cfg: Config, device) -> torch.nn.Module:
    """The eval-mode model ``cfg.model`` names (``models.zoo.get_model``)
    with the numpy pytree weights ``(params, state)``, on ``device``."""
    model = get_model(cfg.model)
    load_model_pytrees(model, params, state)
    return model.to(device)


@torch.inference_mode()
def score_model(model: torch.nn.Module, graph, cfg: Config,
                device) -> np.ndarray:
    """Edge logits [E] (float32, host edge order) of ``graph`` under
    ``model``: the SymGatedGCN at ``cfg.compute.dtype``; a zoo model (in
    float32) on its transformed graph.  Spans (``utils.timing``):
    ``score.request`` around the call; ``score.graph_build``,
    ``score.features`` and ``score.copy`` inside it, beside the model's
    own."""
    with span("score.request"):
        with span("score.graph_build"):
            g = DeviceGraph.from_graph(graph, device)
            g_proc = processor_graph(cfg.model, graph.src, graph.dst,
                                     graph.num_nodes, device)
        with span("score.features"):
            x = torch.as_tensor(node_features(graph), device=device)
            e = torch.as_tensor(edge_features(graph,
                                              cfg.data.use_similarities),
                                device=device)
        if cfg.model.model in SYM_NAMES:
            logits = model(g, x, e, dtype=compute_dtype(cfg))
        else:
            logits = model(*((g, x, e) if g_proc is None
                             else (g, x, e, g_proc)))
        with span("score.copy"):
            return logits.reshape(-1).cpu().numpy()


def rank_scores(graph, model, cfg: Config, group):
    """This rank's part of scoring ``graph`` over ``group``: host-order
    logits [E] on rank 0, None on the others; the halo path for the
    batch-norm SymGatedGCN, the sharded path for every other model."""
    from .parallel.halo import halo_score_graph, halo_supported
    from .parallel.sharded import sharded_score_graph

    fn = (halo_score_graph if halo_supported(cfg.model)
          else sharded_score_graph)
    return fn(graph, model, cfg, group, verbose=True)


def _score_rank(group, graph, params, state, cfg: Config):
    model = load_model(params, state, cfg, group.device)
    return rank_scores(graph, model, cfg, group)


def score_graph(graph, params, state, cfg: Config | None = None) -> np.ndarray:
    """Edge logits [E] for a host graph with the numpy pytree weights, on
    ``cfg.compute.device`` (over ``compute.mesh`` ranks when it is > 1)."""
    from .parallel.group import run, wants_group

    cfg = cfg or Config()
    if wants_group(cfg.compute.mesh):
        check_compute(cfg, "infer")
        return run(_score_rank, cfg.compute.mesh, graph, params, state, cfg,
                   device=cfg.compute.device)
    device = resolve_device(cfg.compute.device)
    return score_model(load_model(params, state, cfg, device), graph, cfg,
                       device)


def _needs_scores(cfg: Config, predicts_path: str) -> bool:
    return not (cfg.decode.decode_with_labels or cfg.decode.random_baseline
                or os.path.isfile(predicts_path))


def _inference_rank(group, *args):
    return run_inference(*args, group=group)


def _halo_score_dataset(ds, model_path: str, cfg: Config, group,
                        decode_dir: str) -> list:
    """Every rank scores its shard of each graph of ``ds`` for which rank 0
    finds no logits cache (its decision, broadcast: another host's disk
    may hold other files); rank 0 writes the caches.  Returns every rank's
    kernel launches (``parallel.halo.rank_launches``)."""
    from .parallel.halo import rank_launches

    model = None
    for idx, graph in ds:
        predicts_path = os.path.join(decode_dir, f"{idx}_predicts.npy")
        if not group.broadcast(group.rank == 0
                               and _needs_scores(cfg, predicts_path)):
            continue
        if model is None:
            params, state = load_model_weights(model_path)
            model = load_model(params, state, cfg, group.device)
        scores = rank_scores(graph, model, cfg, group)
        if group.rank == 0:
            np.save(predicts_path, scores)
    return rank_launches(group)


def run_inference(data_path: str, model_path: str, assembler: str,
                  savedir: str, cfg: Config | None = None,
                  verbose: bool = True, group=None) -> dict | None:
    """Full inference over every graph in a dataset directory
    (reference inference.py:364-501).  With ``compute.mesh > 1`` and no
    ``group`` it spawns the ranks and returns rank 0's summary (in a
    launcher's rank: joins its group, and returns this rank's); a rank of
    a group returns None unless it is rank 0."""
    from .parallel.group import run, wants_group

    cfg = cfg or Config()
    if group is None and wants_group(cfg.compute.mesh):
        check_compute(cfg, "infer")
        return run(_inference_rank, cfg.compute.mesh, data_path, model_path,
                   assembler, savedir, cfg, verbose,
                   device=cfg.compute.device)
    device = (group.device if group is not None
              else resolve_device(cfg.compute.device))
    rng_np, _ = set_seed(cfg.train.seed)
    timer = Timer("infer.")

    # cache=False: each graph is visited exactly once here
    ds = dataset_for(assembler, data_path, threads=cfg.decode.num_threads,
                     config=cfg, cache=False)
    decode_dir = os.path.join(savedir, "decode")
    checkpoint_dir = os.path.join(savedir, "checkpoint")
    assembly_dir = os.path.join(savedir, "assembly")
    for d in (decode_dir, checkpoint_dir, assembly_dir):
        os.makedirs(d, exist_ok=True)
    if group is not None:
        with timer.phase("score"):
            launches = _halo_score_dataset(ds, model_path, cfg, group,
                                           decode_dir)
        if group.rank != 0:
            return None

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
            elif os.path.isfile(predicts_path) or group is not None:
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
    if group is not None:
        summary["ranks"] = group.size
        summary["rank_launches"] = launches
    if verbose:
        print(timer.summary())
        print(f"peak host memory: {rss_mb:.0f} MB")
    return summary
