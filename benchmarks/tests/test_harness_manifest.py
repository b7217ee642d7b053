"""``BENCHMARK.json`` against the benchmark's contract, every file it names
found by name, no module of JAX or the JAX package loaded, and no result
without a card."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmarks.harness import manifest

ROOT = manifest.ROOT
BENCH = manifest.BENCH_DIR
M = manifest.manifest()
KEYS = ["command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"]
FORBIDDEN = {"jax", "jaxlib", "flax", "gnnome_tpu"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_paths():
    assert list(M) == KEYS
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert os.path.isdir(os.path.join(ROOT, p)) and ".." not in p
    assert len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    for word in M["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in M["paths"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 seconds
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_lines():
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in M[sec]]
        assert len(got) == len(set(got))
        for entry in M[sec]:
            assert manifest.NAME.fullmatch(entry["name"]), entry["name"]
            for key in ("why", "layer"):
                if key in entry:
                    assert _line(entry[key])
    metric_names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in M["end_to_end"] + M["per_layer"]:
        assert manifest.UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    files = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmarks/") and c["file"] not in files
        files.add(c["file"])
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert body["source"] == c["source"] and _line(c["source"])
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in M["workloads"])
        assert os.path.isfile(os.path.join(
            BENCH, "reference", body["reference"] + ".py"))


def test_cells():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert manifest.NAME.fullmatch(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = manifest.cell(w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert os.path.isfile(os.path.join(
            BENCH, "drivers", cell.traffic["driver"] + ".py"))
        assert cell.limits
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


def test_per_layer_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert f"`{m['layer']}`" in perf, m["layer"]
        for w in m.get("workloads", []):
            assert w in cells
            assert "workloads" not in e2e[m["moves"]] or \
                w in e2e[m["moves"]]["workloads"]
        mod = manifest.load_module("metrics", m["name"] + ".py")
        assert callable(mod.read)
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_imported_by_name():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, f)):
                    assert mod.split(".")[0] not in FORBIDDEN, (f, mod)


def test_reference_imports_nothing_of_the_program():
    for f in os.listdir(os.path.join(BENCH, "reference")):
        if f.endswith(".py"):
            mods = set(_imports(os.path.join(BENCH, "reference", f)))
            assert all(m.split(".")[0] in ("torch", "__future__", "math",
                                           "numpy") for m in mods), mods


def test_run_loads_no_jax(tmp_path):
    """A CPU run of a small cell, in a process of its own: no module whose
    top-level name is JAX's or the JAX package's is loaded."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmarks.harness import runner\n"
        "r = runner.run_cell('score-b64-mix', 3, 0.3, True, 'cpu',\n"
        "    traffic_override={'graphs': [256, 512]})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "gnnome_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_no_card_no_result():
    """Without a CUDA device a run exits non-zero and prints no result."""
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         M["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the files under
    ``paths`` a run cannot reach the program: it exits non-zero with no
    result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in M["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\n"
            f"sys.path.insert(0, {str(tmp_path)!r})\n"
            "from benchmarks.harness import runner\n"
            "print(runner.run_cell(sys.argv[1], 1, 0.3, False, 'cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code,
                          M["workloads"][0]["name"]], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "gnnome_tpu_torch" in out.stderr
