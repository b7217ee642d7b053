"""The Mosaic repro scripts on the card: the port's counterpart of
``scripts/mosaic_f32_repro.py`` and ``mosaic_f32_repro2.py`` to
``mosaic_f32_repro5.py``, the TPU scripts that bisected a compiler crash
with a ladder of small Pallas kernels.

    python -m gnnome_tpu_torch.probes.mosaic_repro [--device cuda|cpu]
        [--seed N] [--case NAME ...] [--reps R]

What the scripts' kernel bodies compute comes down to four operations, each
a hand-written CUDA kernel (``csrc/probes/mosaic_ops.cu``) beside its plain
PyTorch version:

- ``row_stack(lo, hi)``: two [h, D] row blocks stacked by rows into
  [2h, D] (the lane halves ``a[:, :D]``, ``a[:, D:]`` of an [h, 2D] array,
  or two arrays); ``inverse`` puts them side by side into [h, 2D];
  ``sigmoid`` applies K3's float32 sigmoid first; ``out`` may be a view
  with a wider row stride (kE's lane padding into a zeroed buffer).
- ``row_gather(table, idx)``: ``table[idx]``, a zero row where an index
  lies outside ``[0, rows)`` (the one-hot select matches nothing there).
- ``segment_sum(idx, pay, rows)``: the one-hot scatter-add, each row's
  terms in ascending order in float32, rounded once to ``pay``'s dtype;
  out-of-range indices dropped; ``dup`` writes ``[s | s]``.
- ``small_matmul(a, b)``: ``a @ b`` with float32 FMA on CUDA cores, no
  TF32 (the float32 HIGHEST product); bf16 operands on the tensor cores,
  accumulated in float32 (the bf16 DEFAULT product).  The scripts' kF,
  float32 at DEFAULT precision, is a TPU pass count: the port runs every
  float32 product with TF32 off, so kF computes kD's function.

``CASES`` holds every case of the five scripts under the script's own
letter or number, the dtype a suffix (``1_float32`` to ``6_float32``,
``A_float32`` to ``G_bfloat16``, ``H_float32`` to ``N_bfloat16``,
``M2_*``, ``L_scratch_*`` (repro3 has an ``L`` too), ``roll_f32_*``,
``barrier_*``): the script's shapes and a chain of the four operations.
Glue between the kernels is views and zeroed allocations only.  Case 6 is
the port's K3
(``ops.kernels.k3_edge_stage``) on ``synthetic_assembly_graph(600, 50000,
500, seed=7)`` with the script's rows (ones and zeros; its affine, ones,
as BatchNorm rows [0, 1, 1, 1]).  Inputs come from ``--seed`` (normal
rows, indices in ``[0, rows)`` with repeats); repro4's and repro5's cases
take the scripts' ``arange`` input.

Each line is one JSON object: the case, its status (``PASS``, ``WRONG``
or ``FAIL`` with the exception's first line: the card's form of the
scripts' ladder), the largest difference from the plain chain, the time
(``ms``: CUDA events around ``--reps`` chains queued behind a sleep
kernel, median of 5; with ``--device cpu`` host-clock ``cpu_ms``), the
plain chain's time and, where one PyTorch call computes the case's whole
function (``torch.cat``, ``index_select``, ``zeros().index_add_``,
``torch.matmul`` with TF32 off), that call's time, the ops the chain
calls, and the bound (its bytes: the input elements the function needs,
such as the table rows a gather names, and the outputs).  Every case is
run and checked; a case with the same function on the same inputs as an
earlier one (the scripts' many ways to one row stack) takes that one's
times and names it in ``timed_as``.  The last line sums the statuses;
the command exits 1 unless every case passes.  Tolerances against the plain chain: stacks and gathers exact;
segment sums within ``SUM_RTOL`` x the summed magnitudes, products within
``PRODUCT_RTOL`` x sum |a||b|, in bf16 also one bf16 spacing of the
result; case 6 as K3 (``K3_EDGE_ATOL``, ``K3_SUM_RTOL``, ``K3_SUM_ATOL``).
A second chain on the kernels must repeat the first bit for bit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import types
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ops import kernels as K
from . import (BF16_FLOPS_PER_S, F32_FLOPS_PER_S, bound, device_label,
               library, raise_on, time_ms, timed)

D, HC, W_ROWS, CHUNK = 64, 256, 256, 512      # the scripts' D, hc, w, chunk
SUM_RTOL, PRODUCT_RTOL = 1e-6, 1e-5
BF16_SPACING = 2.0 ** -7       # a bf16 spacing is at most this x |value|
K3_EDGE_ATOL, K3_SUM_RTOL, K3_SUM_ATOL = 1e-5, 1e-5, 1e-4
K3_GRAPH = dict(n_reads=600, genome_len=50000, read_len=500, seed=7)
SIGMOID_OPS = 4                # -x, exp, 1 + e, 1 / (1 + e)


# ------------------------------------------------------------------ checking
def _same(name: str, lo, hi):
    dt = K._edge_dtype(name, lo)
    if lo.dim() != 2:
        raise ValueError(f"{name}: expected 2-d rows, got {tuple(lo.shape)}")
    K._check(f"{name} hi", hi, dt, lo.shape, lo.device, rows_contiguous=False)
    K._check(f"{name} lo", lo, dt, lo.shape, lo.device, rows_contiguous=False)
    return dt


def _index(name: str, idx, device) -> None:
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: indices of dtype {idx.dtype}, expected "
                        "torch.int32")
    if idx.dim() != 1:
        raise ValueError(f"{name}: indices of shape {tuple(idx.shape)}, "
                         "expected 1-d")
    K._check(f"{name} idx", idx, torch.int32, idx.shape, device)


def _on(name: str, t) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ----------------------------------------------------------------- row stack
def row_stack_plain(lo, hi, inverse: bool = False, sigmoid: bool = False,
                    out=None):
    """``[f(lo); f(hi)]`` by rows (inverse: ``[f(lo) | f(hi)]`` by
    columns); f the identity or, with ``sigmoid``, the float32 sigmoid
    rounded to the dtype.  Written into ``out`` when given."""
    if sigmoid:
        lo, hi = (torch.sigmoid(x.float()).to(x.dtype) for x in (lo, hi))
    res = torch.cat([lo, hi], dim=1 if inverse else 0)
    return res if out is None else out.copy_(res)


def row_stack(lo, hi, inverse: bool = False, sigmoid: bool = False,
              out=None):
    """``row_stack_plain`` by ``gn_row_stack``: ``lo``, ``hi`` [h, D] of one
    dtype (float32 or bfloat16; any row stride, the last dimension
    contiguous), into ``out`` ([2h, D], inverse [h, 2D], any row stride) or
    a new contiguous tensor."""
    dt = _same("row_stack", lo, hi)
    h, d = lo.shape
    shape = (h, 2 * d) if inverse else (2 * h, d)
    if out is not None:
        K._check("row_stack out", out, dt, shape, lo.device,
                 rows_contiguous=False)
    if not _on("row_stack", lo):
        return row_stack_plain(lo, hi, inverse, sigmoid, out)
    dev = lo.device
    out = torch.empty(shape, dtype=dt, device=dev) if out is None else out
    if h == 0 or d == 0:
        return out
    with torch.cuda.device(dev):
        rc = library().gn_row_stack(
            h, d, int(inverse), int(sigmoid), lo.data_ptr(), lo.stride(0),
            hi.data_ptr(), hi.stride(0), out.data_ptr(), out.stride(0),
            int(dt == torch.bfloat16), _stream(dev))
    raise_on(rc, "row_stack")
    row_stack.launches += 1
    return out


# ---------------------------------------------------------------- row gather
def row_gather_plain(table, idx):
    """``table[idx]``, a zero row for an index outside ``[0, rows)``."""
    rows = table.shape[0]
    ok = (idx >= 0) & (idx < rows)
    if rows == 0:
        return table.new_zeros((idx.shape[0], table.shape[1]))
    got = table.index_select(0, torch.where(ok, idx, 0))
    return torch.where(ok[:, None], got, got.new_zeros(()))


def row_gather(table, idx):
    """``row_gather_plain`` by ``gn_row_gather``: ``table`` [rows, W]
    (float32 or bfloat16, any row stride), ``idx`` int32 [n]; returns a
    contiguous [n, W]."""
    dt = K._edge_dtype("row_gather", table)
    K._check("row_gather table", table, dt, table.shape, table.device,
             rows_contiguous=False)
    _index("row_gather", idx, table.device)
    if not _on("row_gather", table):
        return row_gather_plain(table, idx)
    dev = table.device
    n, w = idx.shape[0], table.shape[1]
    out = torch.empty((n, w), dtype=dt, device=dev)
    if n == 0 or w == 0:
        return out
    if table.shape[0] == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        rc = library().gn_row_gather(
            n, table.shape[0], w, idx.data_ptr(), table.data_ptr(),
            table.stride(0), out.data_ptr(), int(dt == torch.bfloat16),
            _stream(dev))
    raise_on(rc, "row_gather")
    row_gather.launches += 1
    return out


# --------------------------------------------------------------- segment sum
def segment_sum_plain(idx, pay, rows: int, dup: bool = False):
    """``out[r] = sum of pay[c] over c with idx[c] == r`` for ``rows`` rows,
    in float32 (``index_add_``: in ascending c on the CPU), rounded once to
    ``pay``'s dtype; indices outside ``[0, rows)`` dropped; ``dup``:
    ``[out | out]``."""
    ok = (idx >= 0) & (idx < rows)
    s = torch.zeros((rows + 1, pay.shape[1]), dtype=torch.float32,
                    device=pay.device)
    # out-of-range terms go to a spare last row (no host sync: the probe
    # times this version on the card)
    s.index_add_(0, torch.where(ok, idx, rows).long(), pay.float())
    s = s[:rows].to(pay.dtype)
    return torch.cat([s, s], dim=1) if dup else s


def segment_sum(idx, pay, rows: int, dup: bool = False):
    """``segment_sum_plain`` by ``gn_segment_sum`` (no atomics: each output
    row adds its terms in ascending c, bitwise reproducible): ``idx`` int32
    [n], ``pay`` [n, W] (float32 or bfloat16, any row stride); returns a
    contiguous [rows, W] (``dup``: [rows, 2W]) in ``pay``'s dtype."""
    dt = K._edge_dtype("segment_sum", pay)
    _index("segment_sum", idx, pay.device)
    if pay.dim() != 2 or pay.shape[0] != idx.shape[0]:
        raise ValueError(f"segment_sum: payload {tuple(pay.shape)} for "
                         f"{idx.shape[0]} indices")
    K._check("segment_sum pay", pay, dt, pay.shape, pay.device,
             rows_contiguous=False)
    if rows < 0:
        raise ValueError(f"segment_sum: {rows} rows")
    if not _on("segment_sum", pay):
        return segment_sum_plain(idx, pay, rows, dup)
    dev = pay.device
    n, w = pay.shape
    out = torch.empty((rows, 2 * w if dup else w), dtype=dt, device=dev)
    if rows == 0 or w == 0:
        return out
    if n == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        rc = library().gn_segment_sum(
            n, rows, w, idx.data_ptr(), pay.data_ptr(), pay.stride(0),
            out.data_ptr(), out.stride(0), int(dup),
            int(dt == torch.bfloat16), _stream(dev))
    raise_on(rc, "segment_sum")
    segment_sum.launches += 1
    return out


# -------------------------------------------------------------- small matmul
def small_matmul_plain(a, b):
    """``a @ b``: every product formed in float32 (exact for bf16 operands),
    summed in float32, rounded once to the dtype; no TF32 anywhere."""
    return (a.float().unsqueeze(2) * b.float().unsqueeze(0)).sum(1).to(
        a.dtype)


def small_matmul(a, b):
    """``small_matmul_plain`` by ``gn_small_matmul``: ``a`` [M, K], ``b``
    [K, N] of one dtype (float32 or bfloat16, any row strides); returns a
    contiguous [M, N].  float32 on CUDA cores (register tiles of 4 x 4
    outputs, no TF32), bf16 on the tensor cores (``mma.sync``); each
    output's sum in a fixed order.  The C entry launches the vector
    instantiation where ``a``, ``b`` and their row strides lie on 16 bytes,
    else the scalar one; ``small_matmul.routes`` counts which ran
    (``matmul_route``)."""
    dt = K._edge_dtype("small_matmul", a)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"small_matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    K._check("small_matmul a", a, dt, a.shape, a.device,
             rows_contiguous=False)
    K._check("small_matmul b", b, dt, b.shape, a.device,
             rows_contiguous=False)
    if not _on("small_matmul", a):
        return small_matmul_plain(a, b)
    dev = a.device
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=dt, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    bf16 = int(dt == torch.bfloat16)
    with torch.cuda.device(dev):
        rc = library().gn_small_matmul(
            m, k, n, a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
            out.data_ptr(), out.stride(0), bf16, _stream(dev))
    raise_on(rc, "small_matmul")
    small_matmul.launches += 1
    small_matmul.routes[matmul_route(a, b)] += 1
    return out


MATMUL_ROUTES = ("vector", "scalar")


def matmul_route(a, b) -> str:
    """The instantiation ``gn_small_matmul`` takes for CUDA tensors ``a``,
    ``b``: ``vector`` (16-byte chunks by cp.async; both tensors and their
    row strides on 16 bytes) or ``scalar`` (element loads), as the C entry
    decides it (``gn_small_matmul_vector``)."""
    vec = library().gn_small_matmul_vector(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        int(a.dtype == torch.bfloat16))
    return MATMUL_ROUTES[0 if vec else 1]


for _fn in (row_stack, row_gather, segment_sum, small_matmul):
    _fn.launches = 0
small_matmul.routes = dict.fromkeys(MATMUL_ROUTES, 0)
OPS = {fn.__name__: fn for fn in (row_stack, row_gather, segment_sum,
                                  small_matmul)}


# ------------------------------------------------------------ the op sets
def _k3(g, *rows):
    u, v, v_csr, u_csr = g.roles(False)
    return K.k3_edge_stage(u, v, v_csr, u_csr, *rows)


def _k3_plain(g, *rows):
    u, v, _, _ = g.roles(False)
    return K.k3_edge_stage_plain(u, v, *rows)


KERNEL = types.SimpleNamespace(**OPS, k3=_k3)
PLAIN = types.SimpleNamespace(
    row_stack=row_stack_plain, row_gather=row_gather_plain,
    segment_sum=segment_sum_plain, small_matmul=small_matmul_plain,
    k3=_k3_plain)


def _abs_stack(lo, hi, inverse=False, sigmoid=False, out=None):
    if not sigmoid:                      # a sigmoid's values are positive
        lo, hi = lo.abs(), hi.abs()
    return row_stack_plain(lo, hi, inverse, sigmoid, out)


# the summed magnitudes behind each output element (sum |terms|, sum
# |a||b|), in float32: the chain on |inputs|
MAGNITUDE = types.SimpleNamespace(
    row_stack=_abs_stack,
    row_gather=lambda table, idx: row_gather_plain(table.abs(), idx),
    segment_sum=lambda idx, pay, rows, dup=False: segment_sum_plain(
        idx, pay.abs(), rows, dup),
    small_matmul=lambda a, b: small_matmul_plain(a.abs(), b.abs()))


class _Count:
    """The plain ops, counting the operations this data needs: products
    2MKN (``mm``), a sum's in-range terms times the width, a sigmoid
    ``SIGMOID_OPS`` an element; stacks and gathers none.  ``used`` names
    the ops the chain calls."""

    def __init__(self):
        self.flops = self.mm = 0.0
        self.used = set()

    def row_stack(self, lo, hi, inverse=False, sigmoid=False, out=None):
        self.used.add("row_stack")
        if sigmoid:
            self.flops += SIGMOID_OPS * 2 * lo.numel()
        return row_stack_plain(lo, hi, inverse, sigmoid, out)

    def row_gather(self, table, idx):
        self.used.add("row_gather")
        return row_gather_plain(table, idx)

    def segment_sum(self, idx, pay, rows, dup=False):
        self.used.add("segment_sum")
        ok = (idx >= 0) & (idx < rows)
        self.flops += float(ok.sum()) * pay.shape[1]
        return segment_sum_plain(idx, pay, rows, dup)

    def small_matmul(self, a, b):
        self.used.add("small_matmul")
        f = 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
        self.flops += f
        self.mm += f
        return small_matmul_plain(a, b)


class _Reads:
    """The chain on read masks (float32 zeros in the inputs' shapes): each
    op sets to 1 the elements of its inputs that the function needs, in
    place, so through views the masks of the chain's inputs; a gather
    needs the table rows that an in-range index names, a sum the payload
    rows with an in-range index, every other op all of its inputs.  Each op
    returns zeros of its output's shape."""

    def row_stack(self, lo, hi, inverse=False, sigmoid=False, out=None):
        lo.fill_(1)
        hi.fill_(1)
        h, d = lo.shape
        if out is not None:
            return out
        return lo.new_zeros((h, 2 * d) if inverse else (2 * h, d))

    def row_gather(self, table, idx):
        ok = (idx >= 0) & (idx < table.shape[0])
        table.index_fill_(0, idx[ok].long(), 1)
        return table.new_zeros((idx.shape[0], table.shape[1]))

    def segment_sum(self, idx, pay, rows, dup=False):
        ok = (idx >= 0) & (idx < rows)
        pay.index_fill_(0, ok.nonzero()[:, 0], 1)
        return pay.new_zeros((rows, pay.shape[1] * (2 if dup else 1)))

    def small_matmul(self, a, b):
        a.fill_(1)
        b.fill_(1)
        return a.new_zeros((a.shape[0], b.shape[1]))


# --------------------------------------------------------------------- cases
def _lanes(a):
    return a[:, :D], a[:, D:]


def _stack(o, a):
    return o.row_stack(*_lanes(a))


def _stack_dot(o, a, w):
    return o.small_matmul(o.row_stack(*_lanes(a)), w)


def _pad_dot(o, a, w):
    buf = torch.zeros((2 * a.shape[0], 2 * D), dtype=a.dtype,
                      device=a.device)
    o.row_stack(*_lanes(a), out=buf[:, :D])
    return o.small_matmul(buf, w)


@dataclass(frozen=True)
class Case:
    """One case of a script: ``args`` the kernel's inputs in the script's
    order, each ``("x", shape)`` (normal rows in the case's dtype), ``("i",
    shape, rows)`` (int32 indices in ``[0, rows)``), ``("arange", shape)``
    (the scripts' ``arange`` rows) or ``("k3",)`` (case 6's graph and
    rows); ``chain(ops, *args)`` the case's function on an op set;
    ``check`` ``exact``, ``sum``, ``product`` or ``k3``; ``library(*args,
    out)`` the one PyTorch call that computes the whole function, if
    any."""
    name: str
    script: str
    line: int
    label: str
    dtype: torch.dtype
    args: tuple
    chain: Callable
    check: str
    library: Optional[Callable] = None


def _lib_stack(a, out):
    return lambda: torch.cat(_lanes(a), 0, out=out)


def _lib_matmul(a, b, out):
    return lambda: torch.matmul(a, b, out=out)


def _cases() -> dict:
    f32, bf16 = torch.float32, torch.bfloat16
    p3, p4, p5, p6, p7 = (f"scripts/mosaic_f32_repro{s}.py"
                          for s in ("", "2", "3", "4", "5"))
    x, i = "x", "i"
    cases = [
        Case("1_float32", p3, 33, "f32 HIGHEST dot [512,256]@[256,128]", f32,
             ((x, (CHUNK, W_ROWS)), (x, (W_ROWS, 2 * D))),
             lambda o, a, b: o.small_matmul(a, b), "product",
             lambda a, b, out: _lib_matmul(a, b, out)),
        Case("2_float32", p3, 33, "one-hot select f32 HIGHEST", f32,
             ((i, (1, CHUNK), W_ROWS), (x, (W_ROWS, 2 * D))),
             lambda o, idx, w: o.row_gather(w, idx[0]), "exact",
             lambda idx, w, out: lambda: torch.index_select(w, 0, idx[0],
                                                            out=out)),
        Case("3_float32", p3, 33, "one-hot scatter accum f32 HIGHEST", f32,
             ((i, (1, CHUNK), W_ROWS), (x, (CHUNK, 2 * D))),
             lambda o, idx, pay: o.segment_sum(idx[0], pay, W_ROWS), "sum",
             lambda idx, pay, out: lambda: torch.zeros_like(out).index_add_(
                 0, idx[0], pay)),
        Case("4_float32", p3, 33, "row-stack concat + dot f32", f32,
             ((x, (HC, 2 * D)), (x, (D, D))), _stack_dot, "product"),
        Case("5_float32", p3, 33, "sigmoid+stack+scatter f32", f32,
             ((i, (1, CHUNK), W_ROWS), (x, (HC, 2 * D))),
             lambda o, idx, g: o.segment_sum(
                 idx[0], o.row_stack(*_lanes(g), sigmoid=True), W_ROWS,
                 dup=True), "sum"),
        Case("6_float32", p3, 33, "full K3 f32", f32, (("k3",),),
             lambda o, g, *rows: o.k3(g, *rows), "k3"),
    ]
    for dt in (f32, bf16):
        tag = str(dt).split(".")[1]
        ab = ((x, (HC, 2 * D)), (x, (D, D)))
        cases += [
            Case(f"A_{tag}", p4, 20, f"A slice+dot {tag}", dt, ab,
                 lambda o, a, w: o.small_matmul(a[:, :D], w), "product",
                 lambda a, w, out: _lib_matmul(a[:, :D], w, out)),
            Case(f"B_{tag}", p4, 20, f"B concat0+dot {tag}", dt,
                 ((x, (HC, D)), (x, (HC, D)), (x, (D, D))),
                 lambda o, a, b, w: o.small_matmul(o.row_stack(a, b), w),
                 "product"),
            Case(f"C_{tag}", p4, 20, f"C slice+concat0 write {tag}", dt,
                 ((x, (HC, 2 * D)),), _stack, "exact", _lib_stack),
            Case(f"D_{tag}", p4, 20, f"D slice+concat0+dot {tag}", dt, ab,
                 _stack_dot, "product"),
            Case(f"E_{tag}", p4, 20, f"E slice+concat0+pad+dot {tag}", dt,
                 ((x, (HC, 2 * D)), (x, (2 * D, D))), _pad_dot, "product"),
            # DEFAULT is a TPU pass count; the port's float32 products run
            # without TF32, so kF computes kD's function
            Case(f"F_{tag}", p4, 20, f"F slice+concat0+dot DEFAULT {tag}",
                 dt, ab, _stack_dot, "product"),
            Case(f"G_{tag}", p4, 20, f"G scatter stacked rhs {tag}", dt,
                 ((i, (1, 2 * HC), W_ROWS), (x, (HC, 2 * D))),
                 lambda o, idx, a: o.segment_sum(idx[0], _stack(o, a),
                                                 W_ROWS), "sum"),
            Case(f"H_{tag}", p5, 30,
                 f"H unstack slice-rows concat-lanes {tag}", dt,
                 ((x, (2 * HC, D)),),
                 lambda o, a: o.row_stack(a[:HC], a[HC:], inverse=True),
                 "exact",
                 lambda a, out: lambda: torch.cat((a[:HC], a[HC:]), 1,
                                                  out=out)),
        ]
        for key, label in (("I", "stack via two stores"),
                           ("J", "stack via dyn-update-slice"),
                           ("K", "stack via reshape-transpose"),
                           ("L", "stack via scratch materialize"),
                           ("M", "stack via roll")):
            cases.append(Case(f"{key}_{tag}", p5, 30, f"{key} {label} {tag}",
                              dt, ((x, (HC, 2 * D)),), _stack, "exact",
                              _lib_stack))
        cases.append(Case(f"N_{tag}", p5, 30,
                          f"N stack via scratch stores + dot {tag}", dt, ab,
                          _stack_dot, "product"))
    # repro4 and repro5 run on the scripts' arange rows; repro3 has an L
    # too, so repro4's is L_scratch
    ar = (("arange", (HC, 2 * D)),)
    for dt in (f32, bf16):
        tag = str(dt).split(".")[1]
        for key, script, line, label in (
                ("M2", p6, 24, "M2 roll-stack"),
                ("L_scratch", p6, 40, "L scratch-stack"),
                ("roll_f32", p7, 15, "roll-stack via f32"),
                ("barrier", p7, 15, "opt-barrier stack")):
            cases.append(Case(f"{key}_{tag}", script, line, f"{label} {tag}",
                              dt, ar, _stack, "exact", _lib_stack))
    return {c.name: c for c in cases}


CASES = _cases()


# -------------------------------------------------------------------- inputs
def k3_inputs(device):
    """Case 6: the port's graph of ``K3_GRAPH`` and the script's rows mapped
    onto K3's arguments: ``proj_u``, ``proj_v`` ones [N, 2D], ``b3e``,
    ``e_in`` zeros [E, D], the affine (ones) as BatchNorm rows [mean 0,
    rsqrt 1, scale 1, bias 1]."""
    from ..graphs import synthetic_assembly_graph
    from ..ops import DeviceGraph

    g, _, _, _ = synthetic_assembly_graph(**K3_GRAPH)
    dg = DeviceGraph.from_graph(g, device)
    n, e = dg.n_nodes, dg.n_edges
    ones = torch.ones((n, 2 * D), device=device)
    bn = torch.ones((4, D), device=device)
    bn[0] = 0.0
    return (dg, ones, ones.clone(), torch.zeros((e, D), device=device),
            torch.zeros((e, D), device=device), bn)


def make_inputs(case: Case, device, seed: int = 0) -> tuple:
    """``case``'s inputs on ``device``, drawn from ``seed``."""
    if case.args[0][0] == "k3":
        return k3_inputs(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for spec in case.args:
        kind, shape = spec[0], spec[1]
        if kind == "i":
            out.append(torch.randint(0, spec[2], shape, generator=gen,
                                     device=device, dtype=torch.int32))
        elif kind == "arange":
            n = shape[0] * shape[1]
            out.append(torch.arange(n, dtype=torch.float32, device=device)
                       .reshape(shape).to(case.dtype))
        else:
            out.append(torch.randn(shape, generator=gen, device=device)
                       .to(case.dtype))
    return tuple(out)


def _tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def run_chain(case: Case, args: tuple, ops=KERNEL) -> tuple:
    """``case``'s chain on ``args`` through ``ops`` (the kernels' wrappers
    by default, which take their plain versions on CPU tensors)."""
    return _tuple(case.chain(ops, *args))


def magnitudes(case: Case, args: tuple) -> tuple:
    """The summed magnitudes behind each output (float32)."""
    wide = tuple(a.float() if a.is_floating_point() else a for a in args)
    return _tuple(case.chain(MAGNITUDE, *wide))


def within(case: Case, got: tuple, ref: tuple, mag=None) -> bool:
    """``got`` against the plain chain's ``ref`` at ``case``'s tolerance
    (the module docstring)."""
    if len(got) != len(ref) or any(g.shape != r.shape or g.dtype != r.dtype
                                   for g, r in zip(got, ref)):
        return False
    if case.check == "exact":
        return all(torch.equal(g, r) for g, r in zip(got, ref))
    if case.check == "k3":
        e, *sums = ((g.float() - r.float()).abs() for g, r in zip(got, ref))
        return bool((e <= K3_EDGE_ATOL).all()) and all(
            bool((s <= K3_SUM_ATOL + K3_SUM_RTOL * r.float().abs()).all())
            for s, r in zip(sums, ref[1:]))
    rtol = SUM_RTOL if case.check == "sum" else PRODUCT_RTOL
    for g, r, m in zip(got, ref, mag):
        g, r = g.float(), r.float()
        tol = rtol * m.to(g.device)
        if case.dtype == torch.bfloat16:
            tol = tol + BF16_SPACING * torch.maximum(g.abs(), r.abs())
        if not bool(((g - r).abs() <= tol).all()):
            return False
    return True


def max_abs_diff(got: tuple, ref: tuple) -> float:
    return max((float((g.float() - r.float()).abs().max()) if g.numel()
                else 0.0) for g, r in zip(got, ref))


def read_bytes(case: Case, args: tuple) -> int:
    """The bytes of ``args`` that ``case``'s function reads: each element
    it needs once (``_Reads``), the indices in full."""
    masks = tuple(torch.zeros(a.shape, device=a.device)
                  if a.is_floating_point() else a for a in args)
    case.chain(_Reads(), *masks)
    return sum((int(m.count_nonzero()) if a.is_floating_point()
                else a.numel()) * a.element_size()
               for a, m in zip(args, masks))


def cost(case: Case, args: tuple):
    """Bytes (each input element the function needs read once, each output
    written once), the operations of ``case`` on ``args``, the peak rate
    they run at (bf16 products at the bf16 tensor-core peak, all else
    float32) and the ops the chain calls."""
    if case.check == "k3":
        from .k3_ablate import cost as k3_cost

        g = args[0]
        nbytes, flops = k3_cost("full", g.n_nodes, g.n_edges, D, 4)
        return nbytes, flops, F32_FLOPS_PER_S, ["k3"]
    count = _Count()
    outs = _tuple(case.chain(count, *args))
    nbytes = read_bytes(case, args) + sum(t.numel() * t.element_size()
                                          for t in outs)
    mm_only = count.mm > 0 and count.mm == count.flops
    rate = (BF16_FLOPS_PER_S if case.dtype == torch.bfloat16 and mm_only
            else F32_FLOPS_PER_S)
    return nbytes, count.flops, rate, sorted(count.used)


@contextlib.contextmanager
def no_tf32():
    """float32 products in full float32 (cuBLAS without TF32)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _function(case: Case) -> tuple:
    """What ``case`` computes on which inputs: cases with one key run one
    chain on the same inputs (the scripts' many ways to one row stack)."""
    return (case.chain, case.args, case.dtype, case.check, case.library)


def run_case(case, device, seed: int = 0, reps: int = 20,
             same: Optional[dict] = None) -> dict:
    """One line of the probe: the chain of ``case`` (a name of ``CASES``
    or a ``Case``) on the kernels (on a CPU device, the plain versions)
    against the plain chain, a second chain bit for bit the first, the
    times and the bound.  ``same``: the row of an earlier case with the
    same function on the same inputs, whose times this row takes
    (``timed_as``) instead of timing the chain again."""
    case = CASES[case] if isinstance(case, str) else case
    device = torch.device(device)
    row = {"probe": "mosaic_repro", "case": case.name,
           "script": f"{case.script}:{case.line}", "label": case.label,
           "dtype": str(case.dtype).split(".")[1], "check": case.check,
           **device_label(device)}
    try:
        args = make_inputs(case, device, seed)
        got = run_chain(case, args)
        again = run_chain(case, args)
        ref = run_chain(case, args, PLAIN)
        mag = None if case.check in ("exact", "k3") else magnitudes(case,
                                                                    args)
        ok = (within(case, got, ref, mag)
              and all(torch.equal(a, b) for a, b in zip(got, again)))
        err = max_abs_diff(got, ref)
        if same is not None:
            pre = "" if device.type == "cuda" else "cpu_"
            times = {k: same[pre + k] for k in ("ms", "plain_ms",
                                                "library_ms")
                     if pre + k in same}
            times["timed_as"] = same["case"]
        else:
            times = {"ms": time_ms(lambda: run_chain(case, args), device,
                                   reps),
                     "plain_ms": time_ms(lambda: run_chain(case, args, PLAIN),
                                         device, reps)}
            if case.library is not None:
                out = torch.empty_like(ref[0])
                with no_tf32():
                    times["library_ms"] = time_ms(case.library(*args, out),
                                                  device, reps)
        nbytes, flops, peak, used = cost(case, args)
    except Exception as e:             # the scripts' FAIL line
        msg = str(e).splitlines()[0][:160] if str(e) else ""
        return {**row, "status": "FAIL", "error": f"{type(e).__name__}: "
                                                  f"{msg}"}
    b_ms, b_by = bound(nbytes, flops, peak)
    row.update(status="PASS" if ok else "WRONG", max_abs_diff=err,
               shapes=[list(a.shape) for a in args if torch.is_tensor(a)],
               ops=used, bytes=nbytes, flops=flops, bound_ms=b_ms,
               bound_by=b_by)
    ms = times.pop("ms")
    timed_as = times.pop("timed_as", None)
    row = timed(row, device, ms, **times)
    return row if timed_as is None else {**row, "timed_as": timed_as}


def run_cases(device, seed: int = 0, names=None, reps: int = 20) -> list:
    """``run_case`` for ``names`` (default: every case, in ``CASES``'
    order); each case is run and checked, and a case whose function and
    inputs an earlier one shares takes that one's times."""
    rows, first = [], {}
    for n in (names or CASES):
        key = _function(CASES[n])
        row = run_case(n, device, seed, reps, first.get(key))
        if row["status"] != "FAIL" and "timed_as" not in row:
            first.setdefault(key, row)
        rows.append(row)
    return rows


def call_sites(rows: list, op: str) -> str:
    """The script call sites whose cases among ``rows`` (``run_cases``')
    call ``op``, each with those cases' names (the dtype suffix dropped)."""
    sites = {}
    for r in rows:
        if op in r.get("ops", ()):
            key = r["case"].rsplit("_", 1)[0]
            names = sites.setdefault(r["script"], [])
            if key not in names:
                names.append(key)
    return ", ".join(f"{s} ({', '.join(n)})" for s, n in sorted(
        sites.items()))


# ------------------------------------------------ the four kernels, timed
# each kernel at P3's shapes (scripts/mosaic_f32_repro.py): the product
# [512, 256] @ [256, 128]; the gather of 512 rows of a [256, 128] table;
# the sum of 512 [., 128] rows into 256; the stack [256, 128] -> [512, 64]
OP_CASES = {"small_matmul": "1", "row_gather": "2", "segment_sum": "3",
            "row_stack": "C"}


def op_times(device, dtype, seed: int = 0, reps: int = 20) -> dict:
    """Each kernel alone at P3's shapes in ``dtype`` (P3's cases 1-3 and
    P4's C, each one kernel; in bf16 at the same shapes): ``run_case``'s
    row per kernel."""
    tag = str(dtype).split(".")[1]
    out = {}
    for name, key in OP_CASES.items():
        base = CASES[f"{key}_float32"]
        case = Case(f"{name}_{tag}", base.script, base.line,
                    f"{name} at P3's shapes, {tag}", dtype, base.args,
                    base.chain, base.check, base.library)
        out[name] = run_case(case, device, seed, reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--case", action="append", choices=list(CASES),
                    metavar="NAME", help="a case (repeatable; default all)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device (--device cpu runs the plain versions)")
    rows = run_cases(dev, args.seed, args.case, args.reps)
    for row in rows:
        print(json.dumps(row), flush=True)
    counts = {s: sum(r["status"] == s for r in rows)
              for s in ("PASS", "WRONG", "FAIL")}
    print(json.dumps({"probe": "mosaic_repro", "cases": len(rows),
                      **counts, **device_label(dev)}), flush=True)
    return 0 if counts["PASS"] == len(rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
