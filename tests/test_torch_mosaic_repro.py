"""The Mosaic repro probe of gnnome_tpu_torch
(``gnnome_tpu_torch/probes/mosaic_repro.py``) on the CPU, where its
wrappers run the plain versions, against the bodies of the five JAX
scripts ``scripts/mosaic_f32_repro.py`` and ``mosaic_f32_repro2.py`` to
``mosaic_f32_repro5.py``.

Each script is loaded with ``importlib``.  For the test's duration
``pl.pallas_call`` is wrapped through ``monkeypatch`` so that it runs in
interpret mode and records each kernel body with its ``out_shape`` and
``scratch_shapes``; ``compile_one`` (repro 1-3) records the case's label
and example arguments instead of compiling.  No file of ``gnnome_tpu/`` or
``scripts/`` changes.  Each recorded body then runs in interpret mode on
seeded numpy inputs of the recorded shapes and dtypes (normal rows;
indices in [-8, 264), so that they repeat and some lie outside the 256
rows) and is held against the port's chain for that case on the same
inputs, one test per case and dtype.  repro4 and repro5 run their own
``main``, which must print ``PASS`` for every line in interpret mode, and
their bodies are held against the port on the scripts' ``arange`` input.

Three bodies, ``k3`` and ``k5`` of repro 1 and ``kG`` of repro 2, add into
an output that nothing initialises (``o_ref[:] += ...``, no input-output
alias): in interpret mode it starts as NaN.  They mean a sum into zeros,
which the port computes, so the test zeroes the output before it calls the
script's body.  repro 1's case 6 no longer runs against the JAX package
(``GraphTensors`` has no ``plan``; ``k3_fused_edge_stage`` now takes the
BatchNorm scale and bias apart), so the port's case 6 is held against the
package's own fused K3 entry (``ops.message.fused_eval_edge_stage``, its
Pallas kernel in interpret mode) on the same graph and rows, and against
``k3_edge_stage_plain``.

Tolerances (``mosaic_repro.within``): stacks and gathers exact (the
one-hot product at HIGHEST adds one value to zeros); segment sums within
1e-6 x the summed magnitudes (the one-hot product adds in another order);
products within 1e-5 x sum |a||b| (XLA's dot and the port's sum add in
other orders); in bf16 also one bf16 spacing of the result (2^-7 of its
magnitude), since two float32 sums that differ in their last bits may
round to neighbouring bf16 values.  Case 6: e_out within 1e-5, node sums
within 1e-4 + 1e-5 |x| (K3's tolerances).
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gnnome_tpu.graphs.synthetic import (
    synthetic_assembly_graph as jax_synthetic_graph)
from gnnome_tpu.ops import message as jmsg
from gnnome_tpu.ops.graph_tensors import GraphTensors, with_windowed_plans
from gnnome_tpu.ops.pallas_kernels import set_interpret

from gnnome_tpu_torch.ops import kernels as K
from gnnome_tpu_torch.probes import launch_counts
from gnnome_tpu_torch.probes import mosaic_repro as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORIG_PALLAS_CALL = pl.pallas_call
ROWS = M.W_ROWS
# the bodies that accumulate into an uninitialised output (the port's
# names of repro 1's k3, k5 and repro 2's kG)
ZEROED = ("3_float32", "5_float32", "G_float32", "G_bfloat16")
REPRO1_ORDER = ("1_float32", "2_float32", "3_float32", "4_float32",
                "5_float32")
BY_LABEL = {c.label: c for c in M.CASES.values()}


def _script(stem):
    spec = importlib.util.spec_from_file_location(
        f"{stem}_tpu_script", os.path.join(ROOT, "scripts", f"{stem}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Recorder:
    """``pl.pallas_call`` in interpret mode, recording every kernel body,
    its keyword arguments and the arguments it was called with."""

    def __init__(self):
        self.made = []

    def __call__(self, kernel, **kw):
        entry = {"kernel": kernel, "kw": kw, "args": None}
        self.made.append(entry)
        fn = ORIG_PALLAS_CALL(kernel, interpret=True, **kw)

        def call(*args):
            entry["args"] = args
            entry["out"] = fn(*args)
            return entry["out"]

        return call


def capture_main(stem, record):
    """Run a script's ``main`` with ``pl.pallas_call`` recording in
    interpret mode and ``compile_one`` (repro 1-3) replaced by
    ``record(rec, label, args)``; returns the recorder, what ``main``
    printed and the exception it raised (None if it ran to its end)."""
    rec = Recorder()
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", rec)
        mod = _script(stem)
        if hasattr(mod, "compile_one"):
            mp.setattr(mod, "compile_one", lambda name, fn, *args:
                       record(rec, name, args))
        try:
            with contextlib.redirect_stdout(buf):
                mod.main()
        except Exception as e:     # noqa: BLE001 - the script's own fault
            return rec, buf.getvalue(), e
    return rec, buf.getvalue(), None


_CAPTURED = {}


def captured(stem):
    """repro 1-3: ``{port case name: (label, example args, seeded inputs,
    the body's output on them or the exception it raised, the body's raw
    output without the zeroing)}`` and the exception ``main`` raised.
    Each body runs at once, inside ``main``'s loop: the bodies read the
    loop's ``dt`` when they run."""
    if stem not in _CAPTURED:
        got = {}

        def record(rec, label, args):
            name = port_name(stem, label, len(got))
            entry = rec.made[-1]
            inputs = seeded(args, seed=sum(map(ord, name)))
            try:
                out = jax_body(entry, inputs, name)
            except Exception as e:     # noqa: BLE001 - recorded
                out = e
            raw = (ORIG_PALLAS_CALL(entry["kernel"], interpret=True,
                                    **entry["kw"])(*inputs)
                   if name in ZEROED else None)
            got[name] = (label, args, inputs, out, raw)

        _, _, err = capture_main(stem, record)
        _CAPTURED[stem] = got, err
    return _CAPTURED[stem]


def seeded(args, seed):
    """numpy inputs of the recorded shapes and dtypes: int32 indices in
    [-8, ROWS + 8), normal rows otherwise."""
    rng = np.random.default_rng(seed)
    out = []
    for a in args:
        if a.dtype == jnp.int32:
            out.append(jnp.asarray(rng.integers(-8, ROWS + 8, a.shape),
                                   jnp.int32))
        else:
            out.append(jnp.asarray(rng.standard_normal(a.shape), a.dtype))
    return out


def to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def zeroed(body):
    """``body`` with its output (the last ref) set to zero first."""
    def kernel(*refs):
        refs[-1][...] = jnp.zeros(refs[-1].shape, refs[-1].dtype)
        body(*refs)
    return kernel


def jax_body(entry, args, name):
    body = entry["kernel"]
    if name in ZEROED:
        body = zeroed(body)
    return ORIG_PALLAS_CALL(body, interpret=True, **entry["kw"])(*args)


def port_name(stem, label, i):
    if stem == "mosaic_f32_repro":
        return REPRO1_ORDER[i]
    return BY_LABEL[label].name


def check_case(case, jax_args, out):
    """The port's chain on ``jax_args`` against the JAX body's ``out``."""
    targs = tuple(to_torch(a) for a in jax_args)
    got = M.run_chain(case, targs)
    ref = (to_torch(out),)
    mag = (None if case.check == "exact"
           else M.magnitudes(case, targs))
    assert M.within(case, got, ref, mag), (
        case.name, M.max_abs_diff(got, ref))


SCRIPT_CASES = (
    [("mosaic_f32_repro", n) for n in REPRO1_ORDER]
    + [(s, c.name) for s, keys in (("mosaic_f32_repro2", "ABCDEFG"),
                                   ("mosaic_f32_repro3", "HIJKLMN"))
       for c in M.CASES.values()
       if c.script.endswith(f"{s}.py") and c.name.split("_")[0] in keys])


@pytest.mark.parametrize("stem,name", SCRIPT_CASES)
def test_case_matches_script_body(stem, name):
    """Every case of repro 1-3 (repro 1's case 6 and repro 3's M below):
    the script's body in interpret mode against the port's chain, at the
    script's shapes and dtypes."""
    got, _ = captured(stem)
    label, args, inputs, out, _ = got[name]
    case = M.CASES[name]
    assert label == case.label or stem == "mosaic_f32_repro"
    assert [tuple(a.shape) for a in args] == [s[1] for s in case.args]
    assert all(a.dtype == (jnp.int32 if s[0] == "i" else
                           jnp.dtype(str(case.dtype).split(".")[1]))
               for a, s in zip(args, case.args))
    if name.startswith("M_"):
        # pltpu.roll takes no negative shift: kM's roll(a, -D, 1) raises
        # while it traces; repro4's kM2, roll(a, D, 1), is the same
        # rotation of 2D lanes and stands in for it
        assert isinstance(out, ValueError) and "non-negative" in str(out)
        rec, _, _ = capture_main("mosaic_f32_repro4", lambda *a: None)
        m2 = next(e for e in rec.made if e["kernel"].__name__ == "kM2"
                  and e["kw"]["out_shape"].dtype == inputs[0].dtype)
        out = ORIG_PALLAS_CALL(m2["kernel"], interpret=True,
                               **m2["kw"])(*inputs)
    check_case(case, inputs, out)


@pytest.mark.parametrize("stem", ["mosaic_f32_repro", "mosaic_f32_repro2",
                                  "mosaic_f32_repro3"])
def test_every_script_case_has_a_port_case(stem):
    got, err = captured(stem)
    want = {"mosaic_f32_repro": 5, "mosaic_f32_repro2": 14,
            "mosaic_f32_repro3": 14}[stem]
    assert len(got) == want and all(n in M.CASES for n in got)
    # repro 1 stops at case 6, which no longer runs against the package
    assert (err is None) == (stem != "mosaic_f32_repro")
    if err is not None:
        assert isinstance(err, AttributeError) and "plan" in str(err)


@pytest.mark.parametrize("name", ["3_float32", "5_float32", "G_float32",
                                  "G_bfloat16"])
def test_accumulating_bodies_need_a_zeroed_output(name):
    """Without the zeroing, interpret mode starts the output as NaN: the
    scripts' ``o_ref[:] += ...`` has no initial value."""
    stem = "mosaic_f32_repro2" if name[0] == "G" else "mosaic_f32_repro"
    got, _ = captured(stem)
    _, _, _, out, raw = got[name]
    assert np.isnan(np.asarray(raw, np.float32)).all()
    assert np.isfinite(np.asarray(out, np.float32)).all()


@pytest.mark.parametrize("stem", ["mosaic_f32_repro4", "mosaic_f32_repro5"])
def test_runtime_scripts_pass_and_match_the_port(stem):
    """repro4 and repro5 check their own results against numpy: in
    interpret mode every line says PASS; each body's output on the
    scripts' ``arange`` input equals the port's chain exactly."""
    rec, printed, err = capture_main(stem, None)
    assert err is None
    lines = printed.splitlines()
    assert len(lines) == 4 and len(rec.made) == 4
    for line, entry in zip(lines, rec.made):
        status, label = line.split(" ", 1)
        assert status == "PASS", line
        case = BY_LABEL[label]
        assert case.script.endswith(f"{stem}.py")
        (a,) = entry["args"]
        assert torch.equal(M.make_inputs(case, "cpu")[0], to_torch(a))
        check_case(case, entry["args"], entry["out"])


@pytest.fixture
def interpret():
    set_interpret(True)
    yield
    set_interpret(False)


def test_case6_k3_matches_jax_fused_edge_stage(interpret):
    """Case 6: the port's K3 on the script's graph and rows against the
    JAX package's fused K3 (interpret mode) and ``k3_edge_stage_plain``."""
    case = M.CASES["6_float32"]
    args = M.k3_inputs("cpu")
    dg = args[0]
    got = M.run_chain(case, args)
    u, v, _, _ = dg.roles(False)
    plain = K.k3_edge_stage_plain(u, v, *args[1:])
    assert all(torch.equal(a, b) for a, b in zip(got, plain))

    g, _, _, _ = jax_synthetic_graph(**M.K3_GRAPH)
    assert g.num_nodes == dg.n_nodes and g.num_edges == dg.n_edges
    gt = GraphTensors.from_graph(g, 256, 128)
    gt = with_windowed_plans(gt, flip_too=True, tile_e=256, window=128)
    d = M.D
    ones = np.ones((g.num_nodes, 2 * d), np.float32)
    zeros = jmsg.pack_edges(gt.edges_to_slots(gt.pad_edges(
        np.zeros((g.num_edges, d), np.float32))))
    e_out_p, sum_v, sum_u = jmsg.fused_eval_edge_stage(
        gt, gt.pad_nodes(ones), gt.pad_nodes(ones), zeros, zeros,
        jnp.ones(d), jnp.ones(d), flip=False)
    ref_e = np.asarray(gt.slots_to_edges(jmsg.unpack_edges(e_out_p)))[
        :g.num_edges]
    n = g.num_nodes
    ref = (torch.from_numpy(ref_e), torch.from_numpy(np.array(sum_v)[:n]),
           torch.from_numpy(np.array(sum_u)[:n]))
    host = (dg.slots_to_edges(got[0]), got[1], got[2])
    assert M.within(case, host, ref)
    assert float(ref[1][:, d:].sum()) > 0      # some node has in-edges


def test_wrappers_refuse_and_skip_empty():
    f32 = torch.float32
    a = torch.randn(8, 6)
    idx = torch.tensor([0, 3, 3, -1, 9], dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        M.row_stack(a.double(), a.double())
    with pytest.raises(TypeError, match="dtype"):
        M.row_stack(a, a.to(torch.bfloat16))
    with pytest.raises(TypeError, match="int32"):
        M.row_gather(a, idx.long())
    with pytest.raises(TypeError, match="int32"):
        M.segment_sum(idx.long(), torch.randn(5, 4), 8)
    with pytest.raises(TypeError, match="dtype"):
        M.small_matmul(a, torch.randn(6, 2, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        M.row_gather(a.t(), idx)
    with pytest.raises(ValueError, match="shapes"):
        M.small_matmul(a, torch.randn(5, 2))
    with pytest.raises(ValueError, match="indices"):
        M.segment_sum(idx, torch.randn(4, 4), 8)
    before = launch_counts()
    assert M.row_stack(a[:0], a[:0]).shape == (0, 6)
    assert M.row_gather(a, idx[:0]).shape == (0, 6)
    z = M.segment_sum(idx[:0], torch.zeros(0, 4), 3, dup=True)
    assert z.shape == (3, 8) and not z.any()
    assert M.small_matmul(a[:0], torch.randn(6, 2)).shape == (0, 2)
    assert launch_counts() == before
    # out-of-range indices: a zero row, a dropped term
    g = M.row_gather(a, idx)
    assert torch.equal(g[3], torch.zeros(6, dtype=f32)) and torch.equal(
        g[4], torch.zeros(6, dtype=f32)) and torch.equal(g[1], a[3])
    s = M.segment_sum(idx, torch.ones(5, 2), 4)
    assert s[:, 0].tolist() == [1.0, 0.0, 0.0, 2.0]


def test_cli_cpu_every_case_passes(tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run(
        [sys.executable, "-m", "gnnome_tpu_torch.probes.mosaic_repro",
         "--device", "cpu", "--reps", "1"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines()]
    rows, summary = lines[:-1], lines[-1]
    assert [r["case"] for r in rows] == list(M.CASES)
    assert all(r["status"] == "PASS" and r["device"] == "cpu"
               and "cpu_ms" in r and "ms" not in r for r in rows)
    assert summary["PASS"] == len(M.CASES) == 42
    # one case, chosen by name
    res = subprocess.run(
        [sys.executable, "-m", "gnnome_tpu_torch.probes.mosaic_repro",
         "--device", "cpu", "--reps", "1", "--case", "G_bfloat16"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0
    assert json.loads(res.stdout.splitlines()[0])["case"] == "G_bfloat16"


def test_bound_bytes_are_what_the_function_reads():
    """A gather reads the table rows that an in-range index names, a sum
    the payload rows with an in-range index, a lane slice its half; the
    bound counts those bytes, each output once."""
    idx = torch.tensor([[0, 3, 3, -1, 9, 7, 0, 300]], dtype=torch.int32)
    table = torch.randn(256, 128)
    case = M.CASES["2_float32"]
    nbytes = M.cost(case, (idx, table))[0]
    assert nbytes == 4 * 8 + 4 * 128 * 4 + 4 * 8 * 128  # rows 0, 3, 7, 9
    pay = torch.randn(8, 128, dtype=torch.bfloat16)
    s3 = M.Case("3_bfloat16", *[getattr(M.CASES["3_float32"], f) for f in (
        "script", "line", "label")], torch.bfloat16,
        M.CASES["3_float32"].args, M.CASES["3_float32"].chain, "sum")
    nbytes, flops, _, used = M.cost(s3, (idx, pay))
    assert nbytes == 4 * 8 + 2 * 128 * 6 + 2 * 256 * 128  # 6 in range
    assert flops == 6 * 128 and used == ["segment_sum"]
    a, w = torch.randn(256, 128), torch.randn(64, 64)
    nbytes, flops, _, used = M.cost(M.CASES["A_float32"], (a, w))
    assert nbytes == 4 * (256 * 64 + 64 * 64 + 256 * 64)
    assert used == ["small_matmul"] and flops == 2.0 * 256 * 64 * 64


def test_cases_share_times_only_with_their_function_and_name_call_sites():
    rows = M.run_cases(torch.device("cpu"), seed=1, reps=1)
    by = {r["case"]: r for r in rows}
    assert [r["status"] for r in rows] == ["PASS"] * len(M.CASES)
    shared = {n: r["timed_as"] for n, r in by.items() if "timed_as" in r}
    assert set(shared) >= {"I_float32", "M_bfloat16", "barrier_bfloat16",
                           "F_float32", "N_bfloat16"}
    names = list(M.CASES)
    for n, first in shared.items():
        assert "timed_as" not in by[first]
        assert names.index(first) < names.index(n)
        assert M._function(M.CASES[n]) == M._function(M.CASES[first])
        assert by[n]["cpu_ms"] == by[first]["cpu_ms"]
    assert M.call_sites(rows, "row_gather") == (
        "scripts/mosaic_f32_repro.py:33 (2)")
    assert M.call_sites(rows, "segment_sum") == (
        "scripts/mosaic_f32_repro.py:33 (3, 5), "
        "scripts/mosaic_f32_repro2.py:20 (G)")
    sites = M.call_sites(rows, "row_stack")
    for site in ("mosaic_f32_repro4.py:24 (M2)",
                 "mosaic_f32_repro4.py:40 (L_scratch)",
                 "mosaic_f32_repro5.py:15 (roll_f32, barrier)"):
        assert site in sites
    assert by["6_float32"]["ops"] == ["k3"]


def test_small_matmul_routes_counted_and_reset():
    """``small_matmul.routes`` counts the launches of each instantiation
    (``matmul_route``: the C entry's choice), ``launch_counts`` reports them
    as ``small_matmul:vector`` and ``small_matmul:scalar`` and
    ``reset_launch_counts`` zeroes them with the rest; a CPU call runs the
    plain version and counts nothing."""
    from gnnome_tpu_torch.probes import reset_launch_counts

    assert M.MATMUL_ROUTES == ("vector", "scalar")
    M.small_matmul.routes["scalar"] += 2
    assert launch_counts()["small_matmul:scalar"] >= 2
    reset_launch_counts()
    zero = launch_counts()
    assert {k: v for k, v in zero.items() if k.startswith("small_matmul")} \
        == {"small_matmul": 0, "small_matmul:vector": 0,
            "small_matmul:scalar": 0}
    assert not any(zero.values())
    a = torch.randn(33, 21)[:, 2:19]            # an offset, strided view
    b = torch.randn(17, 5)
    assert torch.equal(M.small_matmul(a, b), M.small_matmul_plain(a, b))
    assert launch_counts() == zero
