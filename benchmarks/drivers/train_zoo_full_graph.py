"""Full-graph training of a zoo model (the GAT configuration): one resident
graph, plain-BCE Adam steps through the port's ``train/step.py``
``train_step`` in a closed loop.

Traffic parameters as ``train_full_graph``'s: ``nodes``, ``avg_degree``,
``checked_steps``, ``traced_steps``.

The run is ``train_full_graph.Driver``'s (the window, the traced segment,
the release, the reference, the gaps and the check); only set-up differs.
It builds the port's configuration with the model's ``directed`` and
``gat_num_heads`` from the configuration file, lays the graph out through
``host_units`` and ``make_example(..., model_cfg=...)``, so that the
processor graph carries the model's self-loops, and loads the GAT weights
(``harness/gat_weights.py``).  The rate counts the graph's own edges, not
the processor graph's.  One planted fault more: the reference run on the
graph without its self-loops.
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks.harness import gat_weights, graphgen, port, weights
from benchmarks.harness.device import synchronize
from benchmarks.harness.manifest import load_module

_BASE = load_module("drivers", "train_full_graph.py")


def port_config(c: dict):
    """The port's ``Config`` for a zoo model's file ``c``: ``port_config``'s
    sizes, loss and optimiser, with no normalisation and no symmetry loss
    (a zoo model has neither), ``directed`` and the heads."""
    cfg = port.port_config(dict(c, normalization="none", alpha=0.0))
    cfg.model.directed = c["directed"]
    cfg.model.gat_num_heads = c["heads"]
    cfg.train.use_symmetry_loss = False
    return cfg


class Driver(_BASE.Driver):
    def setup(self) -> None:
        import torch
        from gnnome_tpu_torch.train import step as train

        t = [time.perf_counter()]
        self.cfg = cfg = port_config(self.c)
        self.dev = dev = port.device(self.device_name)
        self.graph = g = graphgen.make_graph(
            self.t["nodes"], graphgen.graph_seed(self.seed, 0),
            self.t["avg_degree"])
        t.append(time.perf_counter())
        (unit,) = train.host_units(port.assembly_graph(g), cfg,
                                   np.random.default_rng(0))
        self.ex = train.make_example(unit.in_deg, unit.out_deg, unit.e_feat,
                                     unit.y, unit.src, unit.dst,
                                     unit.n_nodes, dev, model_cfg=cfg.model)
        synchronize(dev)
        t.append(time.perf_counter())
        self.w0 = gat_weights.make_weights(self.c, self.seed, dev)
        self.model = port.model(cfg, self.w0, dev)
        self.opt = train.make_optimizer(self.model, cfg.train.lr)
        self.gen = torch.Generator(device=dev).manual_seed(
            weights.torch_seed(self.seed, 1))
        pos, neg = float((g.y == 1).sum()), float((g.y == 0).sum())
        self.pos_weight = neg / pos if pos and neg else 1.0
        self.unit = (g.num_nodes, g.num_edges)

        names = {p: n for n, p in self.model.named_parameters()}
        losses, grad1 = [], {}
        for k in range(self.t["checked_steps"]):
            loss, _ = self.step()
            losses.append(float(loss))
            if k == 0:
                grad1 = {names[p]: float(s["exp_avg"].double().norm())
                         / (1.0 - _BASE.ADAM_BETA1)
                         for p, s in self.opt.state.items()}
        with torch.no_grad():
            change = {n: float((p.double() - self.w0[n].double()).norm())
                      for n, p in self.model.named_parameters()}
        self.prog = {"losses": losses, "grad1": grad1, "change": change}
        t.append(time.perf_counter())
        self.setup_split = dict(zip(
            ("graph_s", "layout_s", "model_and_checked_steps_s"),
            (b - a for a, b in zip(t, t[1:]))))

    def reference(self, tf32: bool = False, edge_share: float = 1.0,
                  self_loops: bool = True) -> dict:
        """``train_full_graph``'s reference; ``self_loops=False`` runs it on
        the graph without its self-loops."""
        import torch

        ref = load_module("reference", self.c["reference"] + ".py")
        ref.set_float32()
        rg = ref.RefGraph(self.graph, self.dev, self_loops=self_loops)
        gen = torch.Generator(device=self.dev).manual_seed(
            weights.torch_seed(self.seed, 1))
        losses, grad1, change = ref.train_steps(
            self.w0, self.c, rg, self.pos_weight, gen,
            self.t["checked_steps"], tf32=tf32, edge_share=edge_share)
        return {"losses": losses, "grad1": grad1, "change": change}

    def faults(self, ref: dict) -> dict:
        """``train_full_graph``'s faults and the processor graph without its
        self-loops (what a set-up that left out ``model_cfg`` would run)."""
        return dict(super().faults(ref),
                    no_self_loops=self.reference(self_loops=False))
