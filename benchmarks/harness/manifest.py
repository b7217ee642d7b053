"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the harness reads

* ``benchmarks/configs/<config>.json``: the model's sizes, source,
  ``assumed`` and ``reduced``, and the plain reference beside it
  (``benchmarks/reference/<reference>.py``);
* ``benchmarks/traffic/<traffic>.json``: the mix's parameters, and the
  driver that generates and runs it (``benchmarks/drivers/<driver>.py``);
* ``benchmarks/limits/<cell>.json``: the limit of each number the cell's
  check compares;
* ``benchmarks/metrics/<metric>.py``: the reader of each per-layer metric.

Adding a configuration, a mix, a metric or a cell is adding such files and
entries; no file here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_module(*parts):
    """The Python file ``benchmarks/<parts>`` as a module of its own."""
    path = os.path.join(BENCH_DIR, *parts)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    name = "bench_" + re.sub(r"\W", "_", os.path.join(*parts))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list        # the manifest's metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of the manifest with every file it names."""
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in m['workloads']]}")
    e2e = [x for x in m["end_to_end"]
           if "workloads" not in x or name in x["workloads"]]
    e2e_names = {x["name"] for x in e2e}
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=read_json("configs", entry["config"] + ".json"),
        traffic=read_json("traffic", entry["traffic"] + ".json"),
        limits=read_json("limits", name + ".json"),
        end_to_end=e2e,
        per_layer=[x for x in m["per_layer"] if _reports(x, name, e2e_names)])
