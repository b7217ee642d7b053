"""Full-graph training: one resident graph, symmetry-loss Adam steps
through the port's ``train/step.py`` ``train_step`` in a closed loop.

Traffic parameters (``benchmarks/traffic/<mix>.json``): ``nodes``
(the graph's size), ``avg_degree``, ``checked_steps`` (the steps that
set-up runs and the check follows, 3) and ``traced_steps`` (the traced
segment).

Set-up makes the graph from the seed, lays it out through the port's
``host_units`` and ``make_example`` (features, device graph, labels in
slot order), builds the model with the benchmark's weights, Adam, and the
dropout generator, and drives that one training object through the
checked steps, each through ``train_step``, keeping each step's loss, the
first gradient's norms (from Adam's first moment after one step) and the
parameters after the last.  The window then calls ``train_step`` on the
same object until its time is up and ends with a synchronize; the rate is
edges times steps over all the window's time.  The check frees the
program's state and runs the plain reference over the same checked steps.
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks.harness import compare, graphgen, port, weights
from benchmarks.harness.device import synchronize

ADAM_BETA1 = 0.9


class Driver:
    kind = "train"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.c, self.t, self.seed, self.device_name = (config, traffic, seed,
                                                       device)

    def setup(self) -> None:
        import torch
        from gnnome_tpu_torch.train import step as train

        t = [time.perf_counter()]
        self.cfg = cfg = port.port_config(self.c)
        self.dev = dev = port.device(self.device_name)
        self.graph = g = graphgen.make_graph(
            self.t["nodes"], graphgen.graph_seed(self.seed, 0),
            self.t["avg_degree"])
        t.append(time.perf_counter())
        (unit,) = train.host_units(port.assembly_graph(g), cfg,
                                   np.random.default_rng(0))
        self.ex = train.make_example(unit.in_deg, unit.out_deg, unit.e_feat,
                                     unit.y, unit.src, unit.dst,
                                     unit.n_nodes, dev)
        synchronize(dev)
        t.append(time.perf_counter())
        self.w0 = weights.make_weights(self.c, self.seed, dev,
                                       eval_state=False)
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
                         / (1.0 - ADAM_BETA1)
                         for p, s in self.opt.state.items()}
        with torch.no_grad():
            change = {n: float((p.double() - self.w0[n].double()).norm())
                      for n, p in self.model.named_parameters()}
        self.prog = {"losses": losses, "grad1": grad1, "change": change}
        t.append(time.perf_counter())
        self.setup_split = dict(zip(
            ("graph_s", "layout_s", "model_and_checked_steps_s"),
            (b - a for a, b in zip(t, t[1:]))))

    def step(self):
        from gnnome_tpu_torch.train import step as train

        return train.train_step(self.model, self.opt, self.ex,
                                self.pos_weight, self.cfg, self.gen)

    def window(self, seconds: float) -> dict:
        synchronize(self.dev)
        t0 = time.perf_counter()
        n = 0
        while True:
            self.step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        synchronize(self.dev)
        dt = time.perf_counter() - t0
        return {"seconds": dt, "units": [self.unit] * n, "attempted": n,
                "failed": 0,
                "metrics": {"train_edges_per_s": n * self.unit[1] / dt}}

    def traced(self) -> list:
        for _ in range(self.t["traced_steps"]):
            self.step()
        return [self.unit] * self.t["traced_steps"]

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        import torch

        del self.model, self.opt, self.ex, self.gen
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, edge_share: float = 1.0) -> dict:
        """The plain reference over the checked steps, from the same weights,
        graph and dropout seed."""
        import torch

        from benchmarks.harness.manifest import load_module

        ref = load_module("reference", self.c["reference"] + ".py")
        ref.set_float32()
        rg = ref.RefGraph(self.graph, self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(
            weights.torch_seed(self.seed, 1))
        losses, grad1, change = ref.train_steps(
            self.w0, self.c, rg, self.pos_weight, gen,
            self.t["checked_steps"], tf32=tf32, edge_share=edge_share)
        return {"losses": losses, "grad1": grad1, "change": change}

    def outputs(self) -> dict:
        """What the program produced in the checked steps."""
        return self.prog

    def gaps(self, out: dict, ref: dict) -> dict:
        return compare.train_gaps(out, ref)

    def faults(self, ref: dict) -> dict:
        """The outputs of planted faults, in the reference put in the
        program's place: a step that leaves the state unchanged, and half
        of the edges left out of the loss's mean."""
        still = dict(ref, change={k: 0.0 for k in ref["change"]})
        return {"state_unchanged": still,
                "half_batch": self.reference(edge_share=0.5)}

    def check(self) -> dict:
        self.release()
        return self.gaps(self.outputs(), self.reference())
