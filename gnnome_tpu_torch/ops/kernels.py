"""Hand-written CUDA kernels K1, K2, K3, K6, K7, K8 and K9, their plain
PyTorch versions, and the build that turns ``csrc/*.cu`` into one shared
library.

K3 (edge stage) and K6 (score gate) carry the batch-norm model's forward;
K7 (gate batch statistics), K8 (edge-stage adjoint) and K9 (score-gate
adjoint) carry its training.  K1 (endpoint gathers and gate) and K2
(two-sided aggregation) carry the layer-norm and norm-free model, forward
and backward (``ops/message.py`` wraps them in
``torch.autograd.Function``s).

Each kernel wrapper takes the plain version only when its tensors lie on the
CPU; for CUDA tensors it launches the kernel or raises.  Each wrapper counts
its launches in ``<wrapper>.launches`` (see ``launch_counts``), so a run can
show that its main path went through the kernels.

Build: at first CUDA use, ``nvcc -gencode arch=compute_90a,code=sm_90a``
compiles every source under ``csrc/`` (one process per source, all started
together) and links them into ``build/libgnnome_kernels.so`` at the
repository root, loaded with ctypes through a plain C interface.  The library
is rebuilt when a source is newer than it.  Nothing is built or imported from
the CUDA toolkit when this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libgnnome_kernels.so")
SOURCES = ("k1_gather_gate.cu", "k2_aggregate.cu", "k3_edge_stage.cu",
           "k6_score_gate.cu", "k7_gate_stats.cu", "k8_train_layer_bwd.cu",
           "k9_aggregate.cu")
HEADERS = ("edge_math.cuh", "csr_sum.cuh", "csr_walk.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


# ---------------------------------------------------------------------- build
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _stale() -> bool:
    if not os.path.isfile(LIB_PATH):
        return True
    t = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(os.path.join(CSRC_DIR, s)) > t
               for s in SOURCES + HEADERS)


def build_kernels(force: bool = False) -> str:
    """Compile and link the kernel library if missing or stale; returns its
    path.  The compiler's resource report (``-Xptxas -v``) is kept in
    ``build/nvcc.log``.  Raises with the compiler output on failure."""
    if not force and not _stale():
        return LIB_PATH
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{os.path.splitext(src)[0]}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for src, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        logs.append(f"== {src} (rc={p.returncode})\n{out}")
    log = "\n".join(logs)
    with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
        f.write(log)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    tmp = f"{LIB_PATH}.{tag}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for obj in objs:
        os.remove(obj)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, LIB_PATH)          # atomic for concurrent loaders
    return LIB_PATH


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_kernels())
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.gn_k1_gather_gate.restype = I
            lib.gn_k1_gather_gate.argtypes = [
                L, I, P, P,                  # n_edges, d, u_idx, v_idx
                P, L, P, L,                  # proj_u, ldu, proj_v, ldv
                P, P, P]                     # b3e, out, stream
            lib.gn_k2_aggregate.restype = I
            lib.gn_k2_aggregate.argtypes = [
                I, I, P, P, P, P,            # n_nodes, width, v_ptr, v_perm, u_ptr, u_perm
                P, L, P, L,                  # pay_u, ldu, pay_v, ldv
                P, P, P]                     # sum_u, sum_v, stream
            lib.gn_k3_edge_stage.restype = I
            lib.gn_k3_edge_stage.argtypes = [
                I, I, P, P, P, P, P, P,      # n_nodes, d, v_ptr, v_perm, v_nbr, u_ptr, u_perm, u_nbr
                P, L, P, L,                  # proj_u, ldu, proj_v, ldv
                P, P, P,                     # b3e, e_in, bn
                P, P, P, P]                  # e_out, sum_v, sum_u, stream
            lib.gn_k6_score_gate.restype = I
            lib.gn_k6_score_gate.argtypes = [
                L, I, P, P,                  # n_edges, h, u_idx, v_idx
                P, L, P, L,                  # puv, ldp, be, ldb
                P, P]                        # z, stream
            lib.gn_k7_scratch.restype = None
            lib.gn_k7_scratch.argtypes = [L, I, P, P]
            lib.gn_k7_gate_stats.restype = I
            lib.gn_k7_gate_stats.argtypes = [
                L, I, P, P,                  # n_edges, d, u_idx, v_idx
                P, L, P, L,                  # bu, ldu, bv, ldv
                P, P, P, P, P]               # b3e, partials, tickets, out, stream
            lib.gn_k8_num_blocks.restype = I
            lib.gn_k8_num_blocks.argtypes = [I]
            lib.gn_k8_train_layer_bwd.restype = I
            lib.gn_k8_train_layer_bwd.argtypes = [
                I, I, P, P, P, P, P, P,      # n_nodes, d, v_ptr, v_perm, v_nbr, u_ptr, u_perm, u_nbr
                P, L, P, L,                  # proj_u, ldu, proj_v, ldv
                P, P, P, P, P, P,            # d_sum_u, d_sum_v, b3e, e_in, d_e_out, bn
                P, P, P, P, P, P, P]         # x, d_eo, node_u, node_v, partials, stats, stream
            lib.gn_k9_aggregate.restype = I
            lib.gn_k9_aggregate.argtypes = [I, I, P, P, P, P, P, P, P, P]
            lib.gn_cuda_error_string.restype = ctypes.c_char_p
            lib.gn_cuda_error_string.argtypes = [I]
            _lib = lib
        return _lib


# ------------------------------------------------------------------- checking
def _check(name: str, t: torch.Tensor, dtype, shape, device,
           rows_contiguous: bool = True) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dim() == 2 and t.shape[0] > 0 and t.stride(1) != 1:
        raise ValueError(f"{name}: last dimension must be contiguous")
    if rows_contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_csr(v_csr, u_csr, n: int, E: int, device) -> None:
    """The ``(ptr [N+1], perm [E] or None, nbr [E])`` triples of
    ``DeviceGraph.roles``."""
    for side, (ptr, perm, nbr) in (("v", v_csr), ("u", u_csr)):
        _check(f"{side}_ptr", ptr, torch.int32, (n + 1,), device)
        _check(f"{side}_nbr", nbr, torch.int32, (E,), device)
        if perm is not None:
            _check(f"{side}_perm", perm, torch.int32, (E,), device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().gn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


# ------------------------------------------------------------------------- K1
def k1_gather_gate_plain(u_idx, v_idx, proj_u, proj_v, b3e):
    """Plain PyTorch K1: ``[(B1h[u] + B2h[v]) + b3e | A2h[u] | A3h[v]]``
    ([E, 3d]) with ``proj_u`` = [B1h | A2h], ``proj_v`` = [B2h | A3h]
    ([N, 2d]) and ``b3e`` [E, d] in slot order."""
    d = b3e.shape[1]
    gu = proj_u.index_select(0, u_idx)
    gv = proj_v.index_select(0, v_idx)
    return torch.cat([(gu[:, :d] + gv[:, :d]) + b3e, gu[:, d:], gv[:, d:]],
                     dim=1)


def k1_gather_gate(u_idx, v_idx, proj_u, proj_v, b3e):
    """K1, the unfused endpoint gathers and gate (csrc/k1_gather_gate.cu).
    ``proj_u``/``proj_v`` may be column slices (row-strided) of the
    projection.  Returns what ``k1_gather_gate_plain`` returns."""
    if proj_u.device.type == "cpu":
        return k1_gather_gate_plain(u_idx, v_idx, proj_u, proj_v, b3e)
    if proj_u.device.type != "cuda":
        raise ValueError(f"K1: unsupported device {proj_u.device}")
    dev = proj_u.device
    E, d = b3e.shape
    n = proj_u.shape[0]
    _check("proj_u", proj_u, torch.float32, (n, 2 * d), dev,
           rows_contiguous=False)
    _check("proj_v", proj_v, torch.float32, (n, 2 * d), dev,
           rows_contiguous=False)
    _check("b3e", b3e, torch.float32, (E, d), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, torch.int32, (E,), dev)
    out = torch.empty((E, 3 * d), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k1_gather_gate(
            E, d, _ptr(u_idx), _ptr(v_idx), _ptr(proj_u), proj_u.stride(0),
            _ptr(proj_v), proj_v.stride(0), _ptr(b3e), _ptr(out),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K1")
    k1_gather_gate.launches += 1
    return out


# ------------------------------------------------------------------------- K2
def k2_aggregate_plain(u_idx, v_idx, pay_u, pay_v, n_nodes: int):
    """Plain PyTorch K2: ``(sum_u [N, Dp], sum_v [N, Dp])``, ``pay_u``
    [E, Dp] summed into the u endpoint and ``pay_v`` into the v endpoint."""
    Dp = pay_u.shape[1]
    sum_u = torch.zeros((n_nodes, Dp), dtype=pay_u.dtype, device=pay_u.device)
    sum_u.index_add_(0, u_idx, pay_u)
    sum_v = torch.zeros((n_nodes, Dp), dtype=pay_v.dtype, device=pay_v.device)
    sum_v.index_add_(0, v_idx, pay_v)
    return sum_u, sum_v


def k2_aggregate(u_idx, v_idx, v_csr, u_csr, pay_u, pay_v):
    """K2, the unfused two-sided aggregation (csrc/k2_aggregate.cu).
    ``v_csr`` / ``u_csr`` as for K3; the payloads may be column slices
    (row-strided).  Returns what ``k2_aggregate_plain`` returns."""
    n = v_csr[0].shape[0] - 1
    if pay_u.device.type == "cpu":
        return k2_aggregate_plain(u_idx, v_idx, pay_u, pay_v, n)
    if pay_u.device.type != "cuda":
        raise ValueError(f"K2: unsupported device {pay_u.device}")
    dev = pay_u.device
    E, Dp = pay_u.shape
    for name, t in (("pay_u", pay_u), ("pay_v", pay_v)):
        _check(name, t, torch.float32, (E, Dp), dev, rows_contiguous=False)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, torch.int32, (E,), dev)
    _check_csr(v_csr, u_csr, n, E, dev)
    sum_u = torch.empty((n, Dp), dtype=torch.float32, device=dev)
    sum_v = torch.empty((n, Dp), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k2_aggregate(
            n, Dp, _ptr(v_csr[0]), _ptr(v_csr[1]), _ptr(u_csr[0]),
            _ptr(u_csr[1]), _ptr(pay_u), pay_u.stride(0), _ptr(pay_v),
            pay_v.stride(0), _ptr(sum_u), _ptr(sum_v),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K2")
    k2_aggregate.launches += 1
    return sum_u, sum_v


# ------------------------------------------------------------------------- K3
def k3_edge_stage_plain(u_idx, v_idx, proj_u, proj_v, b3e, e_in, bn):
    """Plain PyTorch K3: ``(e_out [E, d], sum_v [N, 2d], sum_u [N, 2d])``.
    ``proj_u`` = [B1h | A2h], ``proj_v`` = [B2h | A3h] ([N, 2d]); ``u_idx``,
    ``v_idx`` the flip-resolved endpoints per slot; ``bn`` [4, d] the eval
    BatchNorm rows [mean, rsqrt(var + eps), weight, bias].  Node sums reduce
    with ``index_add_`` (sequential on the CPU, atomic on the GPU)."""
    d = b3e.shape[1]
    n = proj_u.shape[0]
    gu = proj_u.index_select(0, u_idx)
    gv = proj_v.index_select(0, v_idx)
    x = (gu[:, :d] + gv[:, :d]) + b3e
    e_out = torch.relu(((x - bn[0]) * bn[1]) * bn[2] + bn[3]) + e_in
    sigma = torch.sigmoid(e_out)
    sum_v = torch.zeros((n, 2 * d), dtype=b3e.dtype, device=b3e.device)
    sum_v.index_add_(0, v_idx, torch.cat([sigma * gu[:, d:], sigma], dim=1))
    sum_u = torch.zeros((n, 2 * d), dtype=b3e.dtype, device=b3e.device)
    sum_u.index_add_(0, u_idx, torch.cat([sigma * gv[:, d:], sigma], dim=1))
    return e_out, sum_v, sum_u


def k3_edge_stage(u_idx, v_idx, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn):
    """K3, the fused eval edge stage (csrc/k3_edge_stage.cu).  ``v_csr`` /
    ``u_csr`` = ``(ptr [N+1], perm [E] or None, nbr [E])`` list each node's
    slots in the v / u role and their partner nodes (``DeviceGraph.roles``).
    Any d; rows that are 16-byte aligned with d divisible by 4 take the
    kernel's float4 path.  Returns what ``k3_edge_stage_plain`` returns."""
    if proj_u.device.type == "cpu":
        return k3_edge_stage_plain(u_idx, v_idx, proj_u, proj_v, b3e, e_in,
                                   bn)
    if proj_u.device.type != "cuda":
        raise ValueError(f"K3: unsupported device {proj_u.device}")
    dev = proj_u.device
    E, d = b3e.shape
    n = proj_u.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check("proj_u", proj_u, f32, (n, 2 * d), dev, rows_contiguous=False)
    _check("proj_v", proj_v, f32, (n, 2 * d), dev, rows_contiguous=False)
    for name, t in (("b3e", b3e), ("e_in", e_in)):
        _check(name, t, f32, (E, d), dev)
    _check("bn", bn, f32, (4, d), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, i32, (E,), dev)
    _check_csr(v_csr, u_csr, n, E, dev)
    e_out = torch.empty_like(b3e)
    sum_v = torch.empty((n, 2 * d), dtype=f32, device=dev)
    sum_u = torch.empty((n, 2 * d), dtype=f32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k3_edge_stage(
            n, d, *map(_ptr, v_csr), *map(_ptr, u_csr),
            _ptr(proj_u), proj_u.stride(0), _ptr(proj_v), proj_v.stride(0),
            _ptr(b3e), _ptr(e_in), _ptr(bn),
            _ptr(e_out), _ptr(sum_v), _ptr(sum_u),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K3")
    k3_edge_stage.launches += 1
    return e_out, sum_v, sum_u


# ------------------------------------------------------------------------- K6
def k6_score_gate_plain(u_idx, v_idx, puv, be):
    """Plain PyTorch K6: ``relu(pu[u] + pv[v] + be)`` with ``puv`` = [pu | pv]
    ([N, 2H]) and ``be`` [E, H] in slot order."""
    H = be.shape[1]
    return torch.relu((puv.index_select(0, u_idx)[:, :H]
                       + puv.index_select(0, v_idx)[:, H:]) + be)


def k6_score_gate(u_idx, v_idx, puv, be):
    """K6, the fused score-predictor first layer (csrc/k6_score_gate.cu).
    ``puv``/``be`` may be column slices (row-strided) of wider arrays.
    Returns what ``k6_score_gate_plain`` returns, as a dense [E, H]."""
    if puv.device.type == "cpu":
        return k6_score_gate_plain(u_idx, v_idx, puv, be)
    if puv.device.type != "cuda":
        raise ValueError(f"K6: unsupported device {puv.device}")
    dev = puv.device
    E, H = be.shape
    f32, i32 = torch.float32, torch.int32
    _check("puv", puv, f32, (puv.shape[0], 2 * H), dev, rows_contiguous=False)
    _check("be", be, f32, (E, H), dev, rows_contiguous=False)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, i32, (E,), dev)
    z = torch.empty((E, H), dtype=f32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k6_score_gate(E, H, _ptr(u_idx), _ptr(v_idx), _ptr(puv),
                                  puv.stride(0), _ptr(be), be.stride(0),
                                  _ptr(z),
                                  torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K6")
    k6_score_gate.launches += 1
    return z


# ------------------------------------------------------------------------- K7
def k7_gate_stats_plain(u_idx, v_idx, bu, bv, b3e):
    """Plain PyTorch K7: ``[sum x | sum x*x]`` ([2d], float64) over the edge
    slots of ``x = bu[u] + bv[v] + b3e`` (``bu`` = B1h, ``bv`` = B2h,
    [N, d]).  Sums in float64 (``x*x`` of a float32 is exact there)."""
    x = (bu.index_select(0, u_idx) + bv.index_select(0, v_idx)) + b3e
    x = x.double()
    return torch.cat([x.sum(0), (x * x).sum(0)])


_K7_TICKETS: dict = {}     # (device index, stream) -> int32 tickets


def _k7_scratch(lib, dev, stream: int, E: int, d: int):
    """K7's scratch for E edges at width d on one stream: the number of
    float64 partial-sum rows its launch writes, and at least as many int32
    tickets as it takes, zero.  The tickets are kept from call to call
    (each launch leaves them at zero), one set per stream, so launches on
    two streams never share one."""
    rows, n_tickets = ctypes.c_int(), ctypes.c_int()
    lib.gn_k7_scratch(E, d, ctypes.byref(rows), ctypes.byref(n_tickets))
    key = (dev.index, stream)
    tickets = _K7_TICKETS.get(key)
    if tickets is None or tickets.numel() < n_tickets.value:
        tickets = _K7_TICKETS[key] = torch.zeros(
            max(n_tickets.value, 64), dtype=torch.int32, device=dev)
    return rows.value, tickets


def k7_gate_stats(u_idx, v_idx, bu, bv, b3e):
    """K7, the training gate's batch statistics (csrc/k7_gate_stats.cu).
    ``bu``/``bv`` may be column slices (row-strided) of the projection.
    Returns what ``k7_gate_stats_plain`` returns."""
    if bu.device.type == "cpu":
        return k7_gate_stats_plain(u_idx, v_idx, bu, bv, b3e)
    if bu.device.type != "cuda":
        raise ValueError(f"K7: unsupported device {bu.device}")
    dev = bu.device
    E, d = b3e.shape
    n = bu.shape[0]
    _check("bu", bu, torch.float32, (n, d), dev, rows_contiguous=False)
    _check("bv", bv, torch.float32, (n, d), dev, rows_contiguous=False)
    _check("b3e", b3e, torch.float32, (E, d), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, torch.int32, (E,), dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rows, tickets = _k7_scratch(lib, dev, stream, E, d)
        partials = torch.empty((rows, 2 * d), dtype=torch.float64,
                               device=dev)
        out = torch.empty(2 * d, dtype=torch.float64, device=dev)
        rc = lib.gn_k7_gate_stats(
            E, d, _ptr(u_idx), _ptr(v_idx), _ptr(bu), bu.stride(0),
            _ptr(bv), bv.stride(0), _ptr(b3e), _ptr(partials),
            _ptr(tickets), _ptr(out), stream)
    _raise_on(rc, "K7")
    k7_gate_stats.launches += 1
    return out


# ------------------------------------------------------------------------- K8
def k8_train_layer_bwd_plain(u_idx, v_idx, d_sum_u, d_sum_v, proj_u, proj_v,
                             b3e, e_in, d_e_out, bn):
    """Plain PyTorch K8: ``(x [E, d], d_eo [E, d], node_u [N, 3d],
    node_v [N, 3d], stats [2d] float64)``; see csrc/k8_train_layer_bwd.cu.
    ``proj_u`` = [B1h | A2h], ``proj_v`` = [B2h | A3h]; ``d_sum_u`` /
    ``d_sum_v`` the cotangents of K3's ``sum_u`` / ``sum_v``; ``bn`` [4, d]
    the rows [mean, rsqrt(var + eps), gamma, beta] the forward used."""
    d = b3e.shape[1]
    n = proj_u.shape[0]
    gu = proj_u.index_select(0, u_idx)
    gv = proj_v.index_select(0, v_idx)
    du = d_sum_u.index_select(0, u_idx)
    dv = d_sum_v.index_select(0, v_idx)
    x = (gu[:, :d] + gv[:, :d]) + b3e
    y = ((x - bn[0]) * bn[1]) * bn[2] + bn[3]
    sigma = torch.sigmoid(torch.relu(y) + e_in)
    d_sigma = ((dv[:, :d] * gu[:, d:] + dv[:, d:]) + du[:, :d] * gv[:, d:]
               ) + du[:, d:]
    d_eo = d_e_out + (d_sigma * sigma) * (1.0 - sigma)
    d_y = torch.where(y > 0, d_eo, torch.zeros_like(d_eo))
    dys = d_y * (bn[2] * bn[1])
    node_u = torch.zeros((n, 3 * d), dtype=b3e.dtype, device=b3e.device)
    node_u.index_add_(0, u_idx, torch.cat([dys, sigma * dv[:, :d], x], 1))
    node_v = torch.zeros((n, 3 * d), dtype=b3e.dtype, device=b3e.device)
    node_v.index_add_(0, v_idx, torch.cat([dys, sigma * du[:, :d], x], 1))
    d_y64 = d_y.double()
    stats = torch.cat([d_y64.sum(0), (d_y64 * x.double()).sum(0)])
    return x, d_eo, node_u, node_v, stats


def k8_train_layer_bwd(u_idx, v_idx, v_csr, u_csr, d_sum_u, d_sum_v, proj_u,
                       proj_v, b3e, e_in, d_e_out, bn):
    """K8, the training edge stage's adjoint (csrc/k8_train_layer_bwd.cu).
    ``v_csr`` / ``u_csr`` as for K3.  Returns what
    ``k8_train_layer_bwd_plain`` returns."""
    if proj_u.device.type == "cpu":
        return k8_train_layer_bwd_plain(u_idx, v_idx, d_sum_u, d_sum_v,
                                        proj_u, proj_v, b3e, e_in, d_e_out,
                                        bn)
    if proj_u.device.type != "cuda":
        raise ValueError(f"K8: unsupported device {proj_u.device}")
    dev = proj_u.device
    E, d = b3e.shape
    n = proj_u.shape[0]
    f32, i32 = torch.float32, torch.int32
    if n == 0:
        raise ValueError("K8: graph without nodes")
    _check("proj_u", proj_u, f32, (n, 2 * d), dev, rows_contiguous=False)
    _check("proj_v", proj_v, f32, (n, 2 * d), dev, rows_contiguous=False)
    for name, t in (("d_sum_u", d_sum_u), ("d_sum_v", d_sum_v)):
        _check(name, t, f32, (n, 2 * d), dev)
    for name, t in (("b3e", b3e), ("e_in", e_in), ("d_e_out", d_e_out)):
        _check(name, t, f32, (E, d), dev)
    _check("bn", bn, f32, (4, d), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, i32, (E,), dev)
    _check_csr(v_csr, u_csr, n, E, dev)
    lib = _library()
    x = torch.empty_like(b3e)
    d_eo = torch.empty_like(b3e)
    node_u = torch.empty((n, 3 * d), dtype=f32, device=dev)
    node_v = torch.empty((n, 3 * d), dtype=f32, device=dev)
    partials = torch.empty((lib.gn_k8_num_blocks(n), 2 * d),
                           dtype=torch.float64, device=dev)
    stats = torch.empty(2 * d, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gn_k8_train_layer_bwd(
            n, d, *map(_ptr, v_csr), *map(_ptr, u_csr),
            _ptr(proj_u), proj_u.stride(0), _ptr(proj_v), proj_v.stride(0),
            _ptr(d_sum_u), _ptr(d_sum_v), _ptr(b3e), _ptr(e_in),
            _ptr(d_e_out), _ptr(bn), _ptr(x), _ptr(d_eo), _ptr(node_u),
            _ptr(node_v), _ptr(partials), _ptr(stats),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K8")
    k8_train_layer_bwd.launches += 1
    return x, d_eo, node_u, node_v, stats


# ------------------------------------------------------------------------- K9
def k9_aggregate_plain(u_idx, v_idx, pay, n_nodes: int):
    """Plain PyTorch K9: ``(sum_u [N, H], sum_v [N, H])``, the per-edge
    payload ``pay`` [E, H] summed into the u and into the v endpoint."""
    H = pay.shape[1]
    sum_u = torch.zeros((n_nodes, H), dtype=pay.dtype, device=pay.device)
    sum_u.index_add_(0, u_idx, pay)
    sum_v = torch.zeros((n_nodes, H), dtype=pay.dtype, device=pay.device)
    sum_v.index_add_(0, v_idx, pay)
    return sum_u, sum_v


def k9_aggregate(u_idx, v_idx, v_csr, u_csr, pay):
    """K9, the score gate's adjoint (csrc/k9_aggregate.cu).  ``v_csr`` /
    ``u_csr`` as for K3.  Returns what ``k9_aggregate_plain`` returns."""
    n = v_csr[0].shape[0] - 1
    if pay.device.type == "cpu":
        return k9_aggregate_plain(u_idx, v_idx, pay, n)
    if pay.device.type != "cuda":
        raise ValueError(f"K9: unsupported device {pay.device}")
    dev = pay.device
    E, H = pay.shape
    _check("pay", pay, torch.float32, (E, H), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, torch.int32, (E,), dev)
    _check_csr(v_csr, u_csr, n, E, dev)
    sum_u = torch.empty((n, H), dtype=torch.float32, device=dev)
    sum_v = torch.empty((n, H), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k9_aggregate(
            n, H, _ptr(v_csr[0]), _ptr(v_csr[1]), _ptr(u_csr[0]),
            _ptr(u_csr[1]), _ptr(pay), _ptr(sum_u), _ptr(sum_v),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K9")
    k9_aggregate.launches += 1
    return sum_u, sum_v


# ------------------------------------------------------------ launch counting
KERNELS = {"k1_gather_gate": k1_gather_gate, "k2_aggregate": k2_aggregate,
           "k3_edge_stage": k3_edge_stage, "k6_score_gate": k6_score_gate,
           "k7_gate_stats": k7_gate_stats,
           "k8_train_layer_bwd": k8_train_layer_bwd,
           "k9_aggregate": k9_aggregate}
for _fn in KERNELS.values():
    _fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
