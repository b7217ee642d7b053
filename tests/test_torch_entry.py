"""gnnome_tpu_torch/entry.py, the port's entry points, against the
repository's ``__graft_entry__.py``, and the wheel's package data.

* ``entry(device="cpu")`` with the JAX entry's weights
  (``init_params(PRNGKey(0))``, converted through
  ``models/convert.py``): its logits against ``__graft_entry__.entry()``'s
  ``fn(*args)`` under JAX XLA at ``highest`` matmul precision, mapped from
  JAX's padded slot order to host edge order, within ``atol=2e-5,
  rtol=1e-4`` (tests/test_model_parity.py:76's bound).
* ``dryrun_multichip(n, "cpu")`` at n = 2 and 4: a finite loss, equal
  parameters on every rank (the function raises otherwise), and with
  dropout 0 the loss of the port's single-device ``train_step`` on the
  same unit within ``atol=5e-5, rtol=1e-4`` (tests/test_torch_halo_train
  .py's loss bound).
* No quiet fallback: without a GPU both entry points raise.
* Every file under ``gnnome_tpu_torch/csrc/`` is shipped: it matches one of
  pyproject.toml's package-data globs.
"""
import fnmatch
import os
import sys
import tomllib

import jax
import numpy as np
import pytest
import torch

from gnnome_tpu_torch.entry import (ENTRY_GRAPH, dryrun_inputs,
                                    dryrun_multichip, entry)
from gnnome_tpu_torch.parallel.checks import _model
from gnnome_tpu_torch.train.step import (make_example, make_optimizer,
                                         train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
LOSS_TOL = dict(atol=5e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_entry():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as graft
    from gnnome_tpu.config import Config

    fn, args = graft.entry()
    with jax.default_matmul_precision("highest"):
        slots = np.asarray(jax.jit(fn)(*args))
    # the same example again, for its slot layout
    cfg = Config()
    cfg.compute.edge_pad_multiple = 256
    cfg.compute.node_pad_multiple = 64
    cfg.train.masking = False
    g, ex = graft._example(cfg)
    assert ex.slot_io
    host = slots.reshape(-1)[ex.gt.host("slot_of_eid")[: g.num_edges]]
    params, state = (jax.tree_util.tree_map(np.asarray, t)
                     for t in args[:2])
    return g, host, params, state


def test_entry_matches_jax_entry(jax_entry):
    g, ref, params, state = jax_entry
    fn, (x, e) = entry("cpu", weights=(params, state))
    assert x.shape == (g.num_nodes, 2) and e.shape == (g.num_edges, 2)
    lo = fn(x, e).numpy()
    assert lo.shape == (g.num_edges,)
    np.testing.assert_allclose(lo, ref, **LOGIT_TOL)


def test_entry_default_weights_repeat_bitwise():
    fn, args = entry("cpu")
    a, b = fn(*args), fn(*args)
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert a.shape[0] == args[1].shape[0] > 0
    assert ENTRY_GRAPH["n_reads"] == 60


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_matches_single_device_step(n, capsys):
    res = dryrun_multichip(n, "cpu", dropout=0.0)
    line = capsys.readouterr().out
    assert f"dryrun_multichip({n}): halo train step OK (K={res['K']}" in line
    assert np.isfinite(res["loss"]) and len(res["edges_per_rank"]) == n
    unit, params, state, cfg = dryrun_inputs(n, "cpu", dropout=0.0)
    assert sum(res["edges_per_rank"]) == unit.src.shape[0]
    model = _model(params, state, cfg, "cpu")
    ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                      unit.src, unit.dst, unit.n_nodes, "cpu")
    loss, _ = train_step(model, make_optimizer(model, cfg.train.lr), ex, 1.0,
                         cfg, None)
    np.testing.assert_allclose(res["loss"], float(loss), **LOSS_TOL)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a GPU: the refusal it checks")
def test_entry_points_refuse_without_gpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)


def test_package_data_ships_every_source():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "gnnome_tpu_torch"]
    pkg = os.path.join(ROOT, "gnnome_tpu_torch")
    files = []
    for dirpath, dirs, names in os.walk(os.path.join(pkg, "csrc")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        files += [os.path.relpath(os.path.join(dirpath, n), pkg)
                  .replace(os.sep, "/") for n in names]
    assert "csrc/probes/mosaic_ops.cu" in files
    unshipped = [f for f in files
                 if not any(fnmatch.fnmatchcase(f, g) and
                            f.count("/") == g.count("/") for g in globs)]
    assert not unshipped, f"not in package-data: {unshipped}"
