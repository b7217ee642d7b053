"""Scoring resident graphs: the eval forward of ``infer.score_model``
(the model under ``torch.inference_mode``, the logits copied to host
memory) over graphs whose device graphs and features were built in
set-up, one request after another (a closed loop, one client: one
``infer`` process scoring a dataset's graphs).

Traffic parameters (``benchmarks/traffic/<mix>.json``): ``graphs`` (the
node counts of the resident graphs), ``avg_degree``, ``traced_rounds``.

Requests go in rounds: each round is every graph once, in an order drawn
from the seed, so every seed sends the same mix.  A request is timed with
CUDA events from its dispatch until its logits are in host memory; the
rate is the edges of all requests over all the window's time.  The check
compares, for each graph, one of its requests in the window (which one is
drawn from the seed) with the plain reference's logits.
"""
from __future__ import annotations

import math
import time

import numpy as np

from benchmarks.harness import compare, graphgen, port, weights
from benchmarks.harness.device import synchronize

SAMPLE_FROM = 4      # the checked request of a graph is one of its first 4
ORDER_STREAM = 1000  # the seed stream of the order, apart from the graphs'


class Driver:
    kind = "score"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.c, self.t, self.seed, self.device_name = (config, traffic, seed,
                                                       device)

    def setup(self) -> None:
        import torch
        from gnnome_tpu_torch.models.features import (edge_features,
                                                      node_features)
        from gnnome_tpu_torch.ops.graph_tensors import DeviceGraph

        split = {"graph_s": 0.0, "layout_s": 0.0}
        self.cfg = port.port_config(self.c)
        self.dtype = port.compute_dtype(self.cfg)
        self.dev = dev = port.device(self.device_name)
        self.graphs, self.resident = [], []
        for i, n in enumerate(self.t["graphs"]):
            t0 = time.perf_counter()
            g = graphgen.make_graph(n, graphgen.graph_seed(self.seed, i),
                                    self.t["avg_degree"])
            t1 = time.perf_counter()
            split["graph_s"] += t1 - t0
            ag = port.assembly_graph(g)
            self.graphs.append(g)
            self.resident.append((
                DeviceGraph.from_graph(ag, dev),
                torch.as_tensor(node_features(ag), device=dev),
                torch.as_tensor(edge_features(ag, self.cfg.data
                                              .use_similarities),
                                device=dev)))
            synchronize(dev)
            split["layout_s"] += time.perf_counter() - t1
        t0 = time.perf_counter()
        self.w0 = weights.make_weights(self.c, self.seed, dev,
                                       eval_state=True)
        self.model = port.model(self.cfg, self.w0, dev).eval()
        self.rng = np.random.default_rng(       # the requests' order
            graphgen.graph_seed(self.seed, ORDER_STREAM))
        self.pick = self.rng.integers(0, SAMPLE_FROM, len(self.graphs))
        self.kept = [None] * len(self.graphs)
        for i in range(len(self.graphs)):       # every shape once
            self.request(i)
        synchronize(dev)
        split["model_and_warmup_s"] = time.perf_counter() - t0
        self.setup_split = split

    def request(self, i: int) -> np.ndarray:
        """One request: ``score_model``'s forward and copy to the host."""
        import torch

        g, x, e = self.resident[i]
        with torch.inference_mode():
            logits = self.model(g, x, e, dtype=self.dtype)
            return logits.reshape(-1).cpu().numpy()

    def rounds(self):
        while True:
            yield from self.rng.permutation(len(self.graphs)).tolist()

    def window(self, seconds: float) -> dict:
        import torch

        on_card = self.dev.type == "cuda"
        if on_card:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
        seen = [0] * len(self.graphs)
        lat, units, edges, order = [], [], 0, []
        synchronize(self.dev)
        t0 = time.perf_counter()
        for i in self.rounds():
            if on_card:
                ev0.record()
                out = self.request(i)
                ev1.record()
                ev1.synchronize()
                lat.append(ev0.elapsed_time(ev1))
            else:
                r0 = time.perf_counter()
                out = self.request(i)
                lat.append((time.perf_counter() - r0) * 1e3)
            order.append(i)
            if seen[i] <= self.pick[i]:
                self.kept[i] = out
            seen[i] += 1
            g = self.graphs[i]
            units.append((g.num_nodes, g.num_edges))
            edges += g.num_edges
            if time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        by_graph = {}
        for i, ms in zip(order, lat):
            by_graph.setdefault(str(self.graphs[i].num_nodes), []).append(ms)
        return {"seconds": dt, "units": units, "attempted": len(units),
                "failed": 0,
                "metrics": {"score_edges_per_s": edges / dt,
                            "score_p95_ms": float(np.percentile(lat, 95))},
                "latency_p50_ms": {n: float(np.median(v))
                                   for n, v in by_graph.items()}}

    def traced(self) -> list:
        units = []
        for _ in range(self.t["traced_rounds"]):
            for i in self.rng.permutation(len(self.graphs)).tolist():
                self.request(i)
                g = self.graphs[i]
                units.append((g.num_nodes, g.num_edges))
        return units

    def release(self) -> None:
        import torch

        del self.model, self.resident
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False) -> list:
        """The plain reference's logits of every graph, on the device."""
        from benchmarks.harness.manifest import load_module

        ref = load_module("reference", self.c["reference"] + ".py")
        ref.set_float32()
        return [ref.score(self.w0, self.c, ref.RefGraph(g, self.dev), tf32)
                for g in self.graphs]

    def outputs(self) -> list:
        """The checked request of each graph: its logits in host memory."""
        return self.kept

    def gaps(self, out: list, ref: list) -> dict:
        import torch

        return {"logit_gap": max(
            math.inf if o is None else
            compare.logit_gap(torch.as_tensor(o, device=self.dev), r)
            for o, r in zip(out, ref))}

    def faults(self, ref: list) -> dict:
        """The outputs of planted faults, in the reference put in the
        program's place: one logit of the largest graph moved by 1 where
        it is produced, and half of each graph's edges left unscored."""
        altered = [r.clone() for r in ref]
        altered[-1][len(altered[-1]) // 3] += 1.0
        half = [r.clone() for r in ref]
        for r in half:
            r[len(r) // 2:] = 0.0
        return {"answer_altered": altered, "half_batch": half}

    def check(self) -> dict:
        self.release()
        return self.gaps(self.outputs(), self.reference())
