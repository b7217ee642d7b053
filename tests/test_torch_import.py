"""gnnome_tpu_torch stands alone: it imports neither JAX nor any module of
the JAX package ``gnnome_tpu`` (whose name is a prefix of the port's, so
every check matches module names exactly)."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# an import of ``gnnome_tpu`` or ``gnnome_tpu.<x>``; ``gnnome_tpu_torch`` is
# not matched because ``_`` is a word character
_JAX_PKG_IMPORT = re.compile(
    r"^\s*(?:from\s+gnnome_tpu(?:\.[\w.]+)?\s+import|"
    r"import\s+gnnome_tpu(?:\.[\w.]+)?(?:\s|,|$))", re.M)
_JAX_IMPORT = re.compile(r"^\s*(?:from\s+jax[\w.]*\s+import|import\s+jax\b)",
                         re.M)


def _port_sources():
    pkg = os.path.join(ROOT, "gnnome_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "scripts", "torch_eval_profile.py")
    yield os.path.join(ROOT, "scripts", "torch_train_profile.py")
    yield os.path.join(ROOT, "tests", "test_torch_cuda.py")


def test_regex_tells_the_packages_apart():
    assert _JAX_PKG_IMPORT.search("from gnnome_tpu.ops import message")
    assert _JAX_PKG_IMPORT.search("import gnnome_tpu\n")
    assert _JAX_PKG_IMPORT.search("    import gnnome_tpu.native as n")
    assert not _JAX_PKG_IMPORT.search("from gnnome_tpu_torch.ops import x")
    assert not _JAX_PKG_IMPORT.search("import gnnome_tpu_torch\n")
    assert _JAX_IMPORT.search("import jax.numpy as jnp")
    assert not _JAX_IMPORT.search("import jaxtyping_like_name_x")


def test_static_scan_finds_no_jax_package_import():
    seen = 0
    for path in _port_sources():
        with open(path) as f:
            src = f.read()
        seen += 1
        assert not _JAX_PKG_IMPORT.search(src), path
        assert not _JAX_IMPORT.search(src), path
    assert seen > 20


_PROBE = r"""
import sys
import numpy as np
import gnnome_tpu_torch
from gnnome_tpu_torch.config import Config
from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.infer import load_model, score_model
from gnnome_tpu_torch.models.checkpoint import load_model_weights
from gnnome_tpu_torch import cli, native, data, decode  # noqa: F401
from gnnome_tpu_torch.train import loop, step  # noqa: F401

g, _, _, _ = synthetic_assembly_graph(n_reads=40, genome_len=3000,
                                      read_len=300, seed=0)
cfg = Config()
cfg.compute.device = "cpu"
params, state = load_model_weights(sys.argv[1])
lo = score_model(load_model(params, state, cfg, "cpu"), g, cfg, "cpu")
assert lo.shape == (g.num_edges,) and np.isfinite(lo).all()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "gnnome_tpu" or m.startswith("gnnome_tpu."))
print("LOADED", bad)
"""


def test_import_and_cpu_forward_load_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE,
         os.path.join(ROOT, "weights", "weights.npz")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
