"""Hand-written CUDA kernels K1, K2, K3, K6, K7, K8, K9, the batch-norm
edge adjoint, the layer-norm edge stage and its adjoint, the GAT layer's
six kernels and the residual BatchNorm's, their plain PyTorch versions,
and the build that turns ``csrc/*.cu`` into one shared library.

K3 (edge stage) and K6 (score gate) carry the batch-norm model's forward;
K7 (gate batch statistics), K8 (edge-stage adjoint), the batch-norm edge
adjoint (``bn_edge_adjoint``: the per-edge end of the batch-statistics
chain, after K8) and K9 (score-gate adjoint) carry its training.  K1
(endpoint gathers and gate) and K2 (two-sided aggregation) carry the
layer-norm and norm-free model, forward and backward (``ops/message.py``
wraps them in ``torch.autograd.Function``s); between them, in float32, the
layer-norm edge stage (``ln_edge_stage``: LayerNorm, relu, residual,
sigmoid and K2's payloads in one pass) and its adjoint
(``ln_edge_adjoint``), the norm-free model's too with the normalisation
left out.  ``k2_side_sum``, one side of K2's walk as its own entry,
carries the model zoo's reductions into nodes.  Around the GAT layer's
six such walks (``models/zoo.py`` ``gat_conv``, csrc/gat_edge.cu):
``gat_node_logits`` (the attention's node halves el, er),
``gat_edge_softmax`` (the softmax's numerators, a dst walk),
``gat_messages`` (alpha and the weighted rows ``feat[src]``), and in the
backward ``gat_message_adjoint``, ``gat_logit_adjoint`` and
``gat_node_adjoint`` (feat's and the attention vectors' gradients).
The Graph Transformer's training-mode BatchNorm of a residual sum
(``models/norm.residual_batch_norm``, csrc/bn_residual.cu) is
``bn_residual_forward`` (x = a + b, the batch statistics, the running
statistics' update, the normalisation) and ``bn_residual_backward``.

K1, K2, K3, K6, K7, K8, K9 and the edge adjoint run in float32 or
bfloat16 (the JAX package's ``compute.dtype=bfloat16``): each kernel has a
bf16 instantiation, chosen by the ``bf16`` flag its C entry takes from the
tensors' dtype, that reads and writes bf16 rows, computes in float32 and
rounds where the JAX bf16 kernel rounds; its plain version does the same
operations on bf16 tensors.  K2 and K9 sum bf16 payloads into float32
node sums.  The one-sided K2 walk (the zoo), the GAT kernels and the
layer-norm edge stage and its adjoint and the residual BatchNorm take
float32 only (bf16 operands keep the PyTorch chain,
``models/sym_gated_gcn.py``; the zoo runs in float32).

Each kernel wrapper takes the plain version only when its tensors lie on the
CPU; for CUDA tensors it launches the kernel or raises.  With no edges (E =
0, a halo rank whose block holds no edge; for the GAT's node kernels no
node) a wrapper launches nothing and returns what the plain version
returns: empty edge rows, zero node sums, zero float64 statistics (the
residual BatchNorm, which takes batch statistics, raises on no rows,
forward and backward).  Each wrapper counts
its launches in ``<wrapper>.launches``, and those of its bf16 instantiation
also in ``<wrapper>.launches_bf16`` (see ``launch_counts``), so a run can
show that its main path went through the kernels, and in which dtype.

Build: at first CUDA use, ``nvcc -gencode arch=compute_90a,code=sm_90a``
compiles every source of ``SOURCES`` under ``csrc/`` (one process per
source, all started together) and links them into
``build/libgnnome_kernels.so`` at the repository root, loaded with ctypes
through a plain C interface.  ``BUILD_DIR`` is the ``build`` directory
beside the package, so an installed package builds into
``<site-packages>/build``, which the user may not be able to write; run
from a checkout then.  The library is rebuilt when a source or a
header is newer than it.  ``build_library`` builds any such library (the
probes' ``build/libgnnome_probes.so``, ``gnnome_tpu_torch/probes``) and
counts the builds it made in this process (``build_library.builds``, by
library path).
Nothing is built or imported from the CUDA toolkit when this module is
imported.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libgnnome_kernels.so")
SOURCES = ("k1_gather_gate.cu", "k2_aggregate.cu", "k3_edge_stage.cu",
           "k6_score_gate.cu", "k7_gate_stats.cu", "k8_train_layer_bwd.cu",
           "k9_aggregate.cu", "bn_edge_adjoint.cu", "ln_edge_stage.cu",
           "gat_edge.cu", "bn_residual.cu", "gps_attention.cu")
HEADERS = ("edge_math.cuh", "csr_sum.cuh", "csr_walk.cuh",
           "k3_edge_stage.cuh")
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


def _stale(lib_path: str, sources, headers) -> bool:
    if not os.path.isfile(lib_path):
        return True
    t = os.path.getmtime(lib_path)
    return any(os.path.getmtime(os.path.join(CSRC_DIR, s)) > t
               for s in (*sources, *headers))


def build_library(lib_path: str, sources, headers=(),
                  log_name: str = "nvcc.log", force: bool = False) -> str:
    """Compile ``sources`` (paths under ``csrc/``, one ``nvcc`` process each,
    all started together) and link them into the shared library
    ``lib_path`` if it is missing or older than a source or one of
    ``headers``; returns its path.  The compiler's resource report
    (``-Xptxas -v``) is kept in ``build/<log_name>``.  Raises with the
    compiler output on failure."""
    if not force and not _stale(lib_path, sources, headers):
        return lib_path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in sources:
        stem = os.path.splitext(os.path.basename(src))[0]
        obj = os.path.join(BUILD_DIR, f"{stem}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for src, p in zip(sources, procs):
        out, _ = p.communicate()
        logs.append(f"== {src} (rc={p.returncode})\n{out}")
    log = "\n".join(logs)
    with open(os.path.join(BUILD_DIR, log_name), "w") as f:
        f.write(log)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    tmp = f"{lib_path}.{tag}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for obj in objs:
        os.remove(obj)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)          # atomic for concurrent loaders
    build_library.builds[lib_path] = build_library.builds.get(lib_path, 0) + 1
    return lib_path


build_library.builds = {}              # library path -> builds in this process


def build_kernels(force: bool = False) -> str:
    """Build the kernel library (``build_library`` of ``SOURCES``); the
    resource report is ``build/nvcc.log``."""
    return build_library(LIB_PATH, SOURCES, HEADERS, "nvcc.log", force)


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
                P, P, I, P]                  # b3e, out, bf16, stream
            lib.gn_k2_aggregate.restype = I
            lib.gn_k2_aggregate.argtypes = [
                I, I, P, P, P, P,            # n_nodes, width, v_ptr, v_perm, u_ptr, u_perm
                P, L, P, L,                  # pay_u, ldu, pay_v, ldv
                P, P, I, P]                  # sum_u, sum_v, bf16, stream
            lib.gn_k2_side_sum.restype = I
            lib.gn_k2_side_sum.argtypes = [
                I, I, P, P,                  # n_nodes, width, ptr, perm
                P, L, P, P]                  # pay, ld, out, stream
            lib.gn_k3_edge_stage.restype = I
            lib.gn_k3_edge_stage.argtypes = [
                I, I, P, P, P, P, P, P,      # n_nodes, d, v_ptr, v_perm, v_nbr, u_ptr, u_perm, u_nbr
                P, L, P, L,                  # proj_u, ldu, proj_v, ldv
                P, P, P,                     # b3e, e_in, bn
                P, P, P, I, P]               # e_out, sum_v, sum_u, bf16, stream
            lib.gn_k6_score_gate.restype = I
            lib.gn_k6_score_gate.argtypes = [
                L, I, P, P,                  # n_edges, h, u_idx, v_idx
                P, L, P, L,                  # puv, ldp, be, ldb
                P, I, P]                     # z, bf16, stream
            lib.gn_k7_scratch.restype = None
            lib.gn_k7_scratch.argtypes = [L, I, P, P]
            lib.gn_k7_gate_stats.restype = I
            lib.gn_k7_gate_stats.argtypes = [
                L, I, P, P,                  # n_edges, d, u_idx, v_idx
                P, L, P, L,                  # bu, ldu, bv, ldv
                P, P, P, P, I, P]            # b3e, partials, tickets, out, bf16, stream
            lib.gn_k8_num_blocks.restype = I
            lib.gn_k8_num_blocks.argtypes = [I]
            lib.gn_k8_train_layer_bwd.restype = I
            lib.gn_k8_train_layer_bwd.argtypes = [
                I, I, P, P, P, P, P, P,      # n_nodes, d, v_ptr, v_perm, v_nbr, u_ptr, u_perm, u_nbr
                P, L, P, L,                  # proj_u, ldu, proj_v, ldv
                P, P, P, P, P, P,            # d_sum_u, d_sum_v, b3e, e_in, d_e_out, bn
                P, P, P, P, P, P, I, P]      # x, d_eo, node_u, node_v, partials, stats, bf16, stream
            lib.gn_k9_aggregate.restype = I
            lib.gn_k9_aggregate.argtypes = [
                I, I, P, P, P, P,            # n_nodes, h, v_ptr, v_perm, u_ptr, u_perm
                P, L, P, I, P]               # pay, ldp, out, bf16, stream
            lib.gn_bn_edge_adjoint.restype = I
            lib.gn_bn_edge_adjoint.argtypes = [
                L, I, P, P, P, P,            # n_rows, w, x, d_eo, bn, sc
                P, I, P]                     # out, bf16, stream
            lib.gn_ln_edge_stage.restype = I
            lib.gn_ln_edge_stage.argtypes = [
                L, I, ctypes.c_float,        # n_rows, d, eps
                P, P, P, P,                  # g3, e_in, weight, bias
                P, P, P, P, P]               # e_out, pay_u, pay_v, stats, stream
            lib.gn_ln_edge_adjoint_blocks.restype = I
            lib.gn_ln_edge_adjoint_blocks.argtypes = [L]
            lib.gn_ln_edge_adjoint.restype = I
            lib.gn_ln_edge_adjoint.argtypes = [
                L, I, P, P, P, P,            # n_rows, d, u_idx, v_idx, d_sum_u, d_sum_v
                P, P, P, P, P, P,            # g3, e_out, d_e_out, stats, weight, bias
                P, P, P, P, P, P]            # pay_u, pay_v, d_e, partials, d_wb, stream
            lib.gn_bn_residual_blocks.restype = I
            lib.gn_bn_residual_blocks.argtypes = [L, I, I]
            D = ctypes.c_double
            lib.gn_bn_residual_forward.restype = I
            lib.gn_bn_residual_forward.argtypes = [
                L, I, I, P, P, P, P, D, D,   # n_rows, d, vec, a, b, weight, bias, eps, momentum
                P, P, P, P, P, P, P, P]      # x, y, stats, running_mean, running_var, tracked, partials, stream
            lib.gn_bn_residual_backward.restype = I
            lib.gn_bn_residual_backward.argtypes = [
                L, I, I, P, P, P, P,         # n_rows, d, vec, g, x, stats, weight
                P, P, P, P, P]               # dx, dwb, sums, partials, stream
            lib.gn_gat_edge_softmax.restype = I
            lib.gn_gat_edge_softmax.argtypes = [
                I, I, P, P,                  # n_nodes, heads, ptr, src
                P, P, P, P]                  # el, er, expv, stream
            lib.gn_gat_messages.restype = I
            lib.gn_gat_messages.argtypes = [
                L, I, I, P, P,               # n_slots, heads, d, src, dst
                P, P, P, P, P, P]            # feat, expv, denom, msg, alpha, stream
            lib.gn_gat_message_adjoint.restype = I
            lib.gn_gat_message_adjoint.argtypes = [
                L, I, I, P, P,               # n_slots, heads, d, src, dst
                P, P, P, P,                  # d_out, feat, alpha, denom
                P, P, P, P]                  # d_feat, d_expv, pay, stream
            lib.gn_gat_logit_adjoint.restype = I
            lib.gn_gat_logit_adjoint.argtypes = [
                L, I, P, P, P, P,            # n_slots, heads, src, dst, el, er
                P, P, P, P, P]               # expv, d_expv, d_denom, d_x, stream
            lib.gn_gat_node_logits.restype = I
            lib.gn_gat_node_logits.argtypes = [
                L, I, I, P, P, P,            # n_nodes, heads, d, feat, attn_l, attn_r
                P, P, P]                     # el, er, stream
            lib.gn_gat_node_adjoint_blocks.restype = I
            lib.gn_gat_node_adjoint_blocks.argtypes = [I]
            lib.gn_gat_node_adjoint.restype = I
            lib.gn_gat_node_adjoint.argtypes = [
                I, I, I, P, P, P,            # n_nodes, heads, d, feat, attn_l, attn_r
                P, P, P, P, P, P, P]         # d_el, d_er, acc, d_feat, partials, d_attn, stream
            lib.gn_gps_attention_forward.restype = I
            lib.gn_gps_attention_forward.argtypes = [
                L, I, P, P, P, I, I,         # n_tiles, heads, qkv, tiles, seed, layer, drop
                ctypes.c_uint32, ctypes.c_float,  # keep_below, keep_scale
                P, P, P]                     # out, lse, stream
            lib.gn_gps_attention_backward.restype = I
            lib.gn_gps_attention_backward.argtypes = [
                L, L, I, I, P, P, P, I, I,   # n_rows, n_units, heads, splits, qkv, units, seed, layer, drop
                ctypes.c_uint32, ctypes.c_float,  # keep_below, keep_scale
                P, P, P, P, P,               # out, d_out, lse, dvec, d_qkv
                P, P, P]                     # dq_part, tickets, stream
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


def _edge_dtype(name: str, t: torch.Tensor):
    """The element type of a kernel call: float32, or bfloat16 (the JAX
    package's ``compute.dtype=bfloat16``), which launches the kernel's bf16
    instantiation."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {t.dtype}, expected float32 or "
                        "bfloat16")
    return t.dtype


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels compute with it: a bfloat16 tensor in float32,
    any other unchanged (float32, or float64 in the gradient checks)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype ``wide`` gives a tensor of ``dtype``."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _float32_only(name: str, t: torch.Tensor) -> None:
    """The one-sided K2 walk (the zoo's sums) runs in float32 only: the zoo
    ignores the compute dtype, as in the JAX package."""
    if t.dtype == torch.bfloat16:
        raise TypeError(f"{name}: float32 only (the model zoo runs in "
                        "float32 whatever compute.dtype says)")


def _same_dtype(name: str, **tensors) -> None:
    """Every tensor of one kernel call in one dtype: a mixed call is a
    fault of the caller, never promoted quietly."""
    dts = {k: t.dtype for k, t in tensors.items()}
    if len(set(dts.values())) > 1:
        raise TypeError(f"{name}: mixed dtypes {dts}; every operand must be "
                        "of one dtype")


def _count(fn, dtype) -> None:
    """One launch of ``fn``'s kernel, in ``dtype``'s instantiation."""
    fn.launches += 1
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1


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
    ([N, 2d]) and ``b3e`` [E, d] in slot order.  In bfloat16 each add
    rounds to bf16, as the kernel's do."""
    d = b3e.shape[1]
    gu = proj_u.index_select(0, u_idx)
    gv = proj_v.index_select(0, v_idx)
    return torch.cat([(gu[:, :d] + gv[:, :d]) + b3e, gu[:, d:], gv[:, d:]],
                     dim=1)


def k1_gather_gate(u_idx, v_idx, proj_u, proj_v, b3e):
    """K1, the unfused endpoint gathers and gate (csrc/k1_gather_gate.cu).
    ``proj_u``/``proj_v`` may be column slices (row-strided) of the
    projection.  float32 or bfloat16 (every operand and the output of one
    dtype).  Returns what ``k1_gather_gate_plain`` returns."""
    _same_dtype("K1", proj_u=proj_u, proj_v=proj_v, b3e=b3e)
    if proj_u.device.type == "cpu":
        return k1_gather_gate_plain(u_idx, v_idx, proj_u, proj_v, b3e)
    if proj_u.device.type != "cuda":
        raise ValueError(f"K1: unsupported device {proj_u.device}")
    dev = proj_u.device
    E, d = b3e.shape
    n = proj_u.shape[0]
    dt = _edge_dtype("K1", b3e)
    _check("proj_u", proj_u, dt, (n, 2 * d), dev, rows_contiguous=False)
    _check("proj_v", proj_v, dt, (n, 2 * d), dev, rows_contiguous=False)
    _check("b3e", b3e, dt, (E, d), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, torch.int32, (E,), dev)
    out = torch.empty((E, 3 * d), dtype=dt, device=dev)
    if E == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k1_gather_gate(
            E, d, _ptr(u_idx), _ptr(v_idx), _ptr(proj_u), proj_u.stride(0),
            _ptr(proj_v), proj_v.stride(0), _ptr(b3e), _ptr(out),
            int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K1")
    _count(k1_gather_gate, dt)
    return out


# ------------------------------------------------------------------------- K2
def k2_aggregate_plain(u_idx, v_idx, pay_u, pay_v, n_nodes: int):
    """Plain PyTorch K2: ``(sum_u [N, Dp], sum_v [N, Dp])``, ``pay_u``
    [E, Dp] summed into the u endpoint and ``pay_v`` into the v endpoint,
    in ``wide``'s dtype (float32 sums of bfloat16 payloads).  On the CPU
    ``index_add_`` adds each node's terms in slot order, as the kernel does,
    so the two agree bit for bit."""
    pay_u, pay_v = wide(pay_u), wide(pay_v)
    Dp = pay_u.shape[1]
    sum_u = torch.zeros((n_nodes, Dp), dtype=pay_u.dtype, device=pay_u.device)
    sum_u.index_add_(0, u_idx, pay_u)
    sum_v = torch.zeros((n_nodes, Dp), dtype=pay_v.dtype, device=pay_v.device)
    sum_v.index_add_(0, v_idx, pay_v)
    return sum_u, sum_v


def k2_aggregate(u_idx, v_idx, v_csr, u_csr, pay_u, pay_v):
    """K2, the unfused two-sided aggregation (csrc/k2_aggregate.cu).
    ``v_csr`` / ``u_csr`` as for K3; the payloads may be column slices
    (row-strided), float32 or bfloat16 (both of one dtype); the sums are
    float32.  Returns what ``k2_aggregate_plain`` returns."""
    _same_dtype("K2", pay_u=pay_u, pay_v=pay_v)
    n = v_csr[0].shape[0] - 1
    if pay_u.device.type == "cpu":
        return k2_aggregate_plain(u_idx, v_idx, pay_u, pay_v, n)
    if pay_u.device.type != "cuda":
        raise ValueError(f"K2: unsupported device {pay_u.device}")
    dev = pay_u.device
    E, Dp = pay_u.shape
    dt = _edge_dtype("K2", pay_u)
    for name, t in (("pay_u", pay_u), ("pay_v", pay_v)):
        _check(name, t, dt, (E, Dp), dev, rows_contiguous=False)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, torch.int32, (E,), dev)
    _check_csr(v_csr, u_csr, n, E, dev)
    if E == 0:
        return (torch.zeros((n, Dp), dtype=torch.float32, device=dev),
                torch.zeros((n, Dp), dtype=torch.float32, device=dev))
    sum_u = torch.empty((n, Dp), dtype=torch.float32, device=dev)
    sum_v = torch.empty((n, Dp), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k2_aggregate(
            n, Dp, _ptr(v_csr[0]), _ptr(v_csr[1]), _ptr(u_csr[0]),
            _ptr(u_csr[1]), _ptr(pay_u), pay_u.stride(0), _ptr(pay_v),
            pay_v.stride(0), _ptr(sum_u), _ptr(sum_v),
            int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K2")
    _count(k2_aggregate, dt)
    return sum_u, sum_v


def k2_side_sum_plain(idx, pay, n_nodes: int):
    """Plain PyTorch one-sided K2: ``out [N, D]``, ``out[i]`` the sum of the
    rows ``pay[s]`` of the slots with ``idx[s] = i``.  On the CPU
    ``index_add_`` adds each node's rows in slot order, as the kernel does,
    so the two agree bit for bit."""
    out = torch.zeros((n_nodes, pay.shape[1]), dtype=pay.dtype,
                      device=pay.device)
    return out.index_add_(0, idx, pay)


def k2_side_sum(idx, csr, pay):
    """One side of K2's walk (csrc/k2_aggregate.cu ``gn_k2_side_sum``):
    ``idx`` [E] the node of each slot on that side, ``csr`` = ``(ptr
    [N+1], perm [E] or None, nbr [E])`` its slot lists (one of
    ``DeviceGraph.roles``); ``pay`` [E, D] may be a column slice
    (row-strided).  Returns what ``k2_side_sum_plain`` returns.  float32
    only."""
    _float32_only("K2 side sum", pay)
    ptr, perm, _ = csr
    n = ptr.shape[0] - 1
    if pay.device.type == "cpu":
        return k2_side_sum_plain(idx, pay, n)
    if pay.device.type != "cuda":
        raise ValueError(f"K2 side sum: unsupported device {pay.device}")
    dev = pay.device
    E, D = pay.shape
    _check("pay", pay, torch.float32, (E, D), dev, rows_contiguous=False)
    _check("idx", idx, torch.int32, (E,), dev)
    _check("ptr", ptr, torch.int32, (n + 1,), dev)
    if perm is not None:
        _check("perm", perm, torch.int32, (E,), dev)
    if E == 0:
        return torch.zeros((n, D), dtype=torch.float32, device=dev)
    out = torch.empty((n, D), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k2_side_sum(n, D, _ptr(ptr), _ptr(perm), _ptr(pay),
                                pay.stride(0), _ptr(out),
                                torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K2 side sum")
    _count(k2_side_sum, torch.float32)
    return out


# ------------------------------------------------------------------------- K3
def _sum_into(idx, pay, n: int):
    """``pay`` [E, D] summed into the rows ``idx`` of an [n, D] tensor in
    ``wide``'s dtype (the kernels' float32 node sums), returned in
    ``pay``'s dtype."""
    out = torch.zeros((n, pay.shape[1]), dtype=wide_dtype(pay.dtype),
                      device=pay.device)
    return out.index_add_(0, idx, wide(pay)).to(pay.dtype)


def k3_edge_stage_plain(u_idx, v_idx, proj_u, proj_v, b3e, e_in, bn):
    """Plain PyTorch K3: ``(e_out [E, d], sum_v [N, 2d], sum_u [N, 2d])``.
    ``proj_u`` = [B1h | A2h], ``proj_v`` = [B2h | A3h] ([N, 2d]); ``u_idx``,
    ``v_idx`` the flip-resolved endpoints per slot; ``bn`` [4, d] the eval
    BatchNorm rows [mean, rsqrt(var + eps), weight, bias].  Node sums reduce
    with ``index_add_`` (sequential on the CPU, atomic on the GPU).

    In bfloat16 (every tensor bf16; ``bn`` the folded affine [0, 1, scale,
    bias]) each operation on bf16 tensors rounds its result to bf16, the
    kernel's rounding points; sigma is computed in float32 and rounded, and
    the node sums add the bf16 products in float32 and round once."""
    d = b3e.shape[1]
    gu = proj_u.index_select(0, u_idx)
    gv = proj_v.index_select(0, v_idx)
    return k3_rows_plain(u_idx, v_idx, gu[:, :d], gu[:, d:], gv[:, :d],
                         gv[:, d:], b3e, e_in, bn, proj_u.shape[0])


def k3_rows_plain(u_idx, v_idx, b1, a2, b2, a3, b3e, e_in, bn, n: int):
    """K3's arithmetic on rows already gathered per slot ([E, d] each):
    ``b1`` = B1h, ``a2`` = A2h (K3: of u), ``b2`` = B2h, ``a3`` = A3h (K3:
    of v); returns ``k3_edge_stage_plain``'s ``(e_out, sum_v, sum_u)`` for
    ``n`` nodes."""
    x = (b1 + b2) + b3e
    e_out = torch.relu(((x - bn[0]) * bn[1]) * bn[2] + bn[3]) + e_in
    sigma = torch.sigmoid(wide(e_out)).to(b3e.dtype)
    sum_v = _sum_into(v_idx, torch.cat([sigma * a2, sigma], dim=1), n)
    sum_u = _sum_into(u_idx, torch.cat([sigma * a3, sigma], dim=1), n)
    return e_out, sum_v, sum_u


def k3_edge_stage(u_idx, v_idx, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn):
    """K3, the fused eval edge stage (csrc/k3_edge_stage.cu).  ``v_csr`` /
    ``u_csr`` = ``(ptr [N+1], perm [E] or None, nbr [E])`` list each node's
    slots in the v / u role and their partner nodes (``DeviceGraph.roles``).
    Any d; rows aligned to four elements with d divisible by 4 take the
    kernel's vector path.  float32 or bfloat16 (every tensor of one dtype).
    Returns what ``k3_edge_stage_plain`` returns."""
    if proj_u.device.type == "cpu":
        return k3_edge_stage_plain(u_idx, v_idx, proj_u, proj_v, b3e, e_in,
                                   bn)
    if proj_u.device.type != "cuda":
        raise ValueError(f"K3: unsupported device {proj_u.device}")
    dev = proj_u.device
    E, d = b3e.shape
    n = proj_u.shape[0]
    dt, i32 = _edge_dtype("K3", b3e), torch.int32
    _check("proj_u", proj_u, dt, (n, 2 * d), dev, rows_contiguous=False)
    _check("proj_v", proj_v, dt, (n, 2 * d), dev, rows_contiguous=False)
    for name, t in (("b3e", b3e), ("e_in", e_in)):
        _check(name, t, dt, (E, d), dev)
    _check("bn", bn, dt, (4, d), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, i32, (E,), dev)
    _check_csr(v_csr, u_csr, n, E, dev)
    e_out = torch.empty_like(b3e)
    if E == 0:
        return (e_out, torch.zeros((n, 2 * d), dtype=dt, device=dev),
                torch.zeros((n, 2 * d), dtype=dt, device=dev))
    sum_v = torch.empty((n, 2 * d), dtype=dt, device=dev)
    sum_u = torch.empty((n, 2 * d), dtype=dt, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k3_edge_stage(
            n, d, *map(_ptr, v_csr), *map(_ptr, u_csr),
            _ptr(proj_u), proj_u.stride(0), _ptr(proj_v), proj_v.stride(0),
            _ptr(b3e), _ptr(e_in), _ptr(bn),
            _ptr(e_out), _ptr(sum_v), _ptr(sum_u), int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K3")
    _count(k3_edge_stage, dt)
    return e_out, sum_v, sum_u


# ------------------------------------------------------------------------- K6
def k6_score_gate_plain(u_idx, v_idx, puv, be):
    """Plain PyTorch K6: ``relu(pu[u] + pv[v] + be)`` with ``puv`` = [pu | pv]
    ([N, 2H]) and ``be`` [E, H] in slot order; in bfloat16 each add rounds
    to bf16, as the kernel's do."""
    H = be.shape[1]
    return torch.relu((puv.index_select(0, u_idx)[:, :H]
                       + puv.index_select(0, v_idx)[:, H:]) + be)


def k6_score_gate(u_idx, v_idx, puv, be):
    """K6, the fused score-predictor first layer (csrc/k6_score_gate.cu).
    ``puv``/``be`` may be column slices (row-strided) of wider arrays.
    float32 or bfloat16 (``puv``, ``be`` and ``z`` of one dtype).  Returns
    what ``k6_score_gate_plain`` returns, as a dense [E, H]."""
    if puv.device.type == "cpu":
        return k6_score_gate_plain(u_idx, v_idx, puv, be)
    if puv.device.type != "cuda":
        raise ValueError(f"K6: unsupported device {puv.device}")
    dev = puv.device
    E, H = be.shape
    dt, i32 = _edge_dtype("K6", be), torch.int32
    _check("puv", puv, dt, (puv.shape[0], 2 * H), dev, rows_contiguous=False)
    _check("be", be, dt, (E, H), dev, rows_contiguous=False)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, i32, (E,), dev)
    z = torch.empty((E, H), dtype=dt, device=dev)
    if E == 0:
        return z
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k6_score_gate(E, H, _ptr(u_idx), _ptr(v_idx), _ptr(puv),
                                  puv.stride(0), _ptr(be), be.stride(0),
                                  _ptr(z), int(dt == torch.bfloat16),
                                  torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K6")
    _count(k6_score_gate, dt)
    return z


# ------------------------------------------------------------------------- K7
def k7_gate_stats_plain(u_idx, v_idx, bu, bv, b3e):
    """Plain PyTorch K7: ``[sum x | sum x*x]`` ([2d], float64) over the edge
    slots of ``x = bu[u] + bv[v] + b3e`` (``bu`` = B1h, ``bv`` = B2h,
    [N, d]).  Sums in float64 (``x*x`` of a float32 is exact there).  In
    bfloat16 ``x`` rounds to bf16 at each add, as in K3."""
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
    ``bu``/``bv`` may be column slices (row-strided) of the projection;
    float32 or bfloat16 inputs, float64 sums.  Returns what
    ``k7_gate_stats_plain`` returns."""
    if bu.device.type == "cpu":
        return k7_gate_stats_plain(u_idx, v_idx, bu, bv, b3e)
    if bu.device.type != "cuda":
        raise ValueError(f"K7: unsupported device {bu.device}")
    dev = bu.device
    E, d = b3e.shape
    n = bu.shape[0]
    dt = _edge_dtype("K7", b3e)
    _check("bu", bu, dt, (n, d), dev, rows_contiguous=False)
    _check("bv", bv, dt, (n, d), dev, rows_contiguous=False)
    _check("b3e", b3e, dt, (E, d), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, torch.int32, (E,), dev)
    if E == 0:
        return torch.zeros(2 * d, dtype=torch.float64, device=dev)
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
            _ptr(tickets), _ptr(out), int(dt == torch.bfloat16), stream)
    _raise_on(rc, "K7")
    _count(k7_gate_stats, dt)
    return out


# ------------------------------------------------------------------------- K8
def k8_train_layer_bwd_plain(u_idx, v_idx, d_sum_u, d_sum_v, proj_u, proj_v,
                             b3e, e_in, d_e_out, bn):
    """Plain PyTorch K8: ``(x [E, d], d_eo [E, d], node_u [N, 3d],
    node_v [N, 3d], stats [2d] float64)``; see csrc/k8_train_layer_bwd.cu.
    ``proj_u`` = [B1h | A2h], ``proj_v`` = [B2h | A3h]; ``d_sum_u`` /
    ``d_sum_v`` the cotangents of K3's ``sum_u`` / ``sum_v``; ``bn`` [4, d]
    the rows [mean, rsqrt(var + eps), gamma, beta] the forward used.

    In bfloat16 (every tensor bf16, ``bn`` the folded affine [0, 1, scale,
    bias]) x, y and e_out round as in K3, sigma and the adjoint chain are
    float32, ``d_eo`` is rounded to bf16 and ``d_y`` taken from it, the
    node payloads round to bf16 and their float32 sums round once."""
    d = b3e.shape[1]
    n = proj_u.shape[0]
    dt = b3e.dtype
    gu = proj_u.index_select(0, u_idx)
    gv = proj_v.index_select(0, v_idx)
    du = wide(d_sum_u.index_select(0, u_idx))
    dv = wide(d_sum_v.index_select(0, v_idx))
    x = (gu[:, :d] + gv[:, :d]) + b3e
    y = ((x - bn[0]) * bn[1]) * bn[2] + bn[3]
    sigma = torch.sigmoid(wide(torch.relu(y) + e_in))
    a2, a3 = wide(gu[:, d:]), wide(gv[:, d:])
    d_sigma = ((dv[:, :d] * a2 + dv[:, d:]) + du[:, :d] * a3) + du[:, d:]
    d_eo = (wide(d_e_out) + (d_sigma * sigma) * (1.0 - sigma)).to(dt)
    d_y = torch.where(y > 0, d_eo, torch.zeros_like(d_eo))
    dys = (wide(d_y) * (wide(bn[2]) * wide(bn[1]))).to(dt)
    node_u = _sum_into(u_idx, torch.cat([dys, (sigma * dv[:, :d]).to(dt), x],
                                        1), n)
    node_v = _sum_into(v_idx, torch.cat([dys, (sigma * du[:, :d]).to(dt), x],
                                        1), n)
    d_y64 = d_y.double()
    stats = torch.cat([d_y64.sum(0), (d_y64 * x.double()).sum(0)])
    return x, d_eo, node_u, node_v, stats


def k8_train_layer_bwd(u_idx, v_idx, v_csr, u_csr, d_sum_u, d_sum_v, proj_u,
                       proj_v, b3e, e_in, d_e_out, bn):
    """K8, the training edge stage's adjoint (csrc/k8_train_layer_bwd.cu).
    ``v_csr`` / ``u_csr`` as for K3; float32 or bfloat16 (every tensor of
    one dtype).  Returns what ``k8_train_layer_bwd_plain`` returns."""
    if proj_u.device.type == "cpu":
        return k8_train_layer_bwd_plain(u_idx, v_idx, d_sum_u, d_sum_v,
                                        proj_u, proj_v, b3e, e_in, d_e_out,
                                        bn)
    if proj_u.device.type != "cuda":
        raise ValueError(f"K8: unsupported device {proj_u.device}")
    dev = proj_u.device
    E, d = b3e.shape
    n = proj_u.shape[0]
    dt, i32 = _edge_dtype("K8", b3e), torch.int32
    _check("proj_u", proj_u, dt, (n, 2 * d), dev, rows_contiguous=False)
    _check("proj_v", proj_v, dt, (n, 2 * d), dev, rows_contiguous=False)
    for name, t in (("d_sum_u", d_sum_u), ("d_sum_v", d_sum_v)):
        _check(name, t, dt, (n, 2 * d), dev)
    for name, t in (("b3e", b3e), ("e_in", e_in), ("d_e_out", d_e_out)):
        _check(name, t, dt, (E, d), dev)
    _check("bn", bn, dt, (4, d), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, i32, (E,), dev)
    _check_csr(v_csr, u_csr, n, E, dev)
    x = torch.empty_like(b3e)
    d_eo = torch.empty_like(b3e)
    if E == 0:
        return (x, d_eo, torch.zeros((n, 3 * d), dtype=dt, device=dev),
                torch.zeros((n, 3 * d), dtype=dt, device=dev),
                torch.zeros(2 * d, dtype=torch.float64, device=dev))
    if n == 0:
        raise ValueError("K8: graph without nodes")
    lib = _library()
    node_u = torch.empty((n, 3 * d), dtype=dt, device=dev)
    node_v = torch.empty((n, 3 * d), dtype=dt, device=dev)
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
            int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K8")
    _count(k8_train_layer_bwd, dt)
    return x, d_eo, node_u, node_v, stats


# ------------------------------------------------------------------------- K9
def k9_aggregate_plain(u_idx, v_idx, pay, n_nodes: int):
    """Plain PyTorch K9: ``[sum_u | sum_v]`` ([N, 2H], float32), the
    per-edge payload ``pay`` [E, H] (float32 or bfloat16) summed into the u
    and into the v endpoint in float32.  On the CPU ``index_add_`` adds each
    node's terms in slot order, as the kernel does, so the two agree bit
    for bit."""
    pay = wide(pay)
    H = pay.shape[1]
    sum_u = torch.zeros((n_nodes, H), dtype=pay.dtype, device=pay.device)
    sum_u.index_add_(0, u_idx, pay)
    sum_v = torch.zeros((n_nodes, H), dtype=pay.dtype, device=pay.device)
    sum_v.index_add_(0, v_idx, pay)
    return torch.cat([sum_u, sum_v], dim=1)


def k9_aggregate(u_idx, v_idx, v_csr, u_csr, pay):
    """K9, the score gate's adjoint (csrc/k9_aggregate.cu): one launch that
    writes ``[sum_u | sum_v]`` into one [N, 2H] tensor.  ``v_csr`` /
    ``u_csr`` as for K3; ``pay`` may be a column slice (row-strided),
    float32 or bfloat16.  Returns what ``k9_aggregate_plain`` returns."""
    n = v_csr[0].shape[0] - 1
    if pay.device.type == "cpu":
        return k9_aggregate_plain(u_idx, v_idx, pay, n)
    if pay.device.type != "cuda":
        raise ValueError(f"K9: unsupported device {pay.device}")
    dev = pay.device
    E, H = pay.shape
    dt = _edge_dtype("K9", pay)
    _check("pay", pay, dt, (E, H), dev, rows_contiguous=False)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, torch.int32, (E,), dev)
    _check_csr(v_csr, u_csr, n, E, dev)
    if E == 0:
        return torch.zeros((n, 2 * H), dtype=torch.float32, device=dev)
    out = torch.empty((n, 2 * H), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k9_aggregate(
            n, H, _ptr(v_csr[0]), _ptr(v_csr[1]), _ptr(u_csr[0]),
            _ptr(u_csr[1]), _ptr(pay), pay.stride(0), _ptr(out),
            int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K9")
    _count(k9_aggregate, dt)
    return out


# ---------------------------------------------------- batch-norm edge adjoint
def bn_edge_adjoint_plain(x, d_eo, bn, sc):
    """Plain PyTorch batch-norm edge adjoint: ``d_b3e [E, w]``, the per-edge
    end of the training edge stage's batch-statistics chain
    (``ops/message.py``), from K8's ``x`` and ``d_eo`` [E, w], the ``[4, w]``
    rows K3 and K8 took and ``sc`` = ``[gamma * inv | c1 | c2]`` ([3, w], in
    ``wide``'s dtype): the relu mask of ``y = ((x - bn[0]) * bn[1]) * bn[2] +
    bn[3]``, as K3 computes it, picks ``d_y`` from ``d_eo``, and ``d_y *
    sc[0] + (sc[1] + sc[2] * x)`` is formed in ``wide``'s dtype and rounded
    to ``x``'s.  In bfloat16 ``y`` rounds at each operation, as in K3."""
    y = ((x - bn[0]) * bn[1]) * bn[2] + bn[3]
    d_y = torch.where(y > 0, d_eo, torch.zeros_like(d_eo))
    return (wide(d_y) * sc[0] + (sc[1] + sc[2] * wide(x))).to(x.dtype)


def bn_edge_adjoint(x, d_eo, bn, sc):
    """The batch-norm edge adjoint (csrc/bn_edge_adjoint.cu): one streaming
    pass over ``x`` and ``d_eo`` in place of the plain version's elementwise
    passes.  ``x``, ``d_eo`` and ``bn`` float32 or bfloat16 (of one dtype),
    ``sc`` float32; every tensor contiguous.  Returns what
    ``bn_edge_adjoint_plain`` returns, bit for bit."""
    _same_dtype("BN edge adjoint", x=x, d_eo=d_eo, bn=bn)
    if x.device.type == "cpu":
        return bn_edge_adjoint_plain(x, d_eo, bn, sc)
    if x.device.type != "cuda":
        raise ValueError(f"BN edge adjoint: unsupported device {x.device}")
    dev = x.device
    E, w = x.shape
    dt = _edge_dtype("BN edge adjoint", x)
    for name, t in (("x", x), ("d_eo", d_eo)):
        _check(name, t, dt, (E, w), dev)
    _check("bn", bn, dt, (4, w), dev)
    _check("sc", sc, torch.float32, (3, w), dev)
    out = torch.empty_like(x)
    if E == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_bn_edge_adjoint(
            E, w, _ptr(x), _ptr(d_eo), _ptr(bn), _ptr(sc), _ptr(out),
            int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "BN edge adjoint")
    _count(bn_edge_adjoint, dt)
    return out


# ---------------------------------------------------- layer-norm edge stage
def ln_edge_stage_plain(g3, e_in, weight, bias, eps: float):
    """Plain PyTorch layer-norm edge stage: ``(e_out [E, d], pay_u [E, 2d],
    pay_v [E, 2d], stats [E, 2] or None)`` from K1's ``g3`` = [gate | A2h[u]
    | A3h[v]] ([E, 3d]) and ``e_in`` [E, d]: the LayerNorm of the gate in
    the JAX package's form (two-pass row mean and biased variance, ``(x -
    mean) * rsqrt(var + eps) * weight + bias``; ``weight`` None: the
    norm-free stage, no normalisation), relu, the residual ``+ e_in``,
    ``sigma = sigmoid(e_out)`` and K2's payloads ``[sigma * A3h[v] |
    sigma]`` (summed into u) and ``[sigma * A2h[u] | sigma]`` (into v);
    ``stats`` the rows' ``[mean, rsqrt(var + eps)]``.  The operations of the
    unfused layer's PyTorch chain (``models/norm.layer_norm``), so the two
    agree bit for bit."""
    d = e_in.shape[1]
    x, a2, a3 = g3[:, :d], g3[:, d:2 * d], g3[:, 2 * d:]
    stats = None
    if weight is not None:
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        x = (x - mean) * rstd * weight + bias
        stats = torch.cat([mean, rstd], 1)
    e_out = torch.relu(x) + e_in
    sigma = torch.sigmoid(e_out)
    return (e_out, torch.cat([sigma * a3, sigma], 1),
            torch.cat([sigma * a2, sigma], 1), stats)


def ln_edge_stage(g3, e_in, weight, bias, eps: float):
    """The layer-norm edge stage (csrc/ln_edge_stage.cu
    ``ln_edge_stage_kernel``): one pass over the rows of ``g3`` and
    ``e_in`` in place of the plain version's elementwise passes.  float32,
    every tensor contiguous; ``weight`` and ``bias`` [d], or both None (the
    norm-free stage); d at most 512 (128 where d % 4 != 0).  Returns what
    ``ln_edge_stage_plain`` returns; the row sums add in another order than
    ``torch.mean``, so the normalised values differ from it by rounding."""
    if g3.device.type == "cpu":
        return ln_edge_stage_plain(g3, e_in, weight, bias, eps)
    if g3.device.type != "cuda":
        raise ValueError(f"LN edge stage: unsupported device {g3.device}")
    dev = g3.device
    E, d = e_in.shape
    _check("g3", g3, torch.float32, (E, 3 * d), dev)
    _check("e_in", e_in, torch.float32, (E, d), dev)
    if (weight is None) != (bias is None):
        raise ValueError("LN edge stage: weight and bias, or neither")
    if weight is not None:
        _check("weight", weight, torch.float32, (d,), dev)
        _check("bias", bias, torch.float32, (d,), dev)
    e_out = torch.empty_like(e_in)
    pay_u = torch.empty((E, 2 * d), dtype=torch.float32, device=dev)
    pay_v = torch.empty((E, 2 * d), dtype=torch.float32, device=dev)
    stats = (None if weight is None else
             torch.empty((E, 2), dtype=torch.float32, device=dev))
    if E == 0:
        return e_out, pay_u, pay_v, stats
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_ln_edge_stage(
            E, d, eps, _ptr(g3), _ptr(e_in), _ptr(weight), _ptr(bias),
            _ptr(e_out), _ptr(pay_u), _ptr(pay_v), _ptr(stats),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "LN edge stage")
    _count(ln_edge_stage, torch.float32)
    return e_out, pay_u, pay_v, stats


def ln_edge_adjoint_plain(u_idx, v_idx, d_sum_u, d_sum_v, g3, e_out, d_e_out,
                          stats, weight, bias):
    """Plain PyTorch adjoint of the layer-norm edge stage and of K2's sums
    of its payloads: ``(pay_u [E, 2d], pay_v [E, 2d], d_e [E, d], d_wb [2,
    d] or None)``.  ``d_sum_u`` / ``d_sum_v`` [N, 2d] are the cotangents of
    K2's sums, gathered here at ``u_idx`` / ``v_idx``; ``g3``, ``e_out`` and
    ``stats`` the forward's.  ``d_e = d_e_out + d_sigma * sigma * (1 -
    sigma)`` is the cotangent of e_out and, through the residual, of the
    edge state; the relu mask is recomputed from ``g3`` and ``stats`` with
    the forward's operations; the LayerNorm row adjoint is ``((g - mean(g))
    - xhat * mean(g * xhat)) * rstd`` with ``g = d_y * weight``.  The
    payloads are K1's adjoint: ``[d_gate | sigma * d_sum_v[v][:d]]`` into u,
    ``[d_gate | sigma * d_sum_u[u][:d]]`` into v.  ``d_wb`` = [sum d_y *
    xhat | sum d_y] over the rows, the gradients of ``weight`` and ``bias``
    (None for the norm-free stage, whose d_gate is d_e where the gate is
    positive)."""
    d = e_out.shape[1]
    x, a2, a3 = g3[:, :d], g3[:, d:2 * d], g3[:, 2 * d:]
    du = d_sum_u.index_select(0, u_idx)
    dv = d_sum_v.index_select(0, v_idx)
    sigma = torch.sigmoid(e_out)
    d_sigma = ((dv[:, :d] * a2 + dv[:, d:]) + du[:, :d] * a3) + du[:, d:]
    d_e = d_e_out + (d_sigma * sigma) * (1.0 - sigma)
    zero = torch.zeros_like(d_e)
    d_wb = None
    if weight is None:
        d_gate = torch.where(x > 0, d_e, zero)
    else:
        mean, rstd = stats[:, :1], stats[:, 1:]
        xhat = (x - mean) * rstd
        d_y = torch.where(xhat * weight + bias > 0, d_e, zero)
        g = d_y * weight
        d_gate = ((g - g.sum(1, keepdim=True) / d)
                  - xhat * ((g * xhat).sum(1, keepdim=True) / d)) * rstd
        d_wb = torch.stack([(d_y * xhat).sum(0), d_y.sum(0)])
    return (torch.cat([d_gate, sigma * dv[:, :d]], 1),
            torch.cat([d_gate, sigma * du[:, :d]], 1), d_e, d_wb)


def ln_edge_adjoint(u_idx, v_idx, d_sum_u, d_sum_v, g3, e_out, d_e_out,
                    stats, weight, bias):
    """The layer-norm edge stage's adjoint (csrc/ln_edge_stage.cu
    ``ln_edge_adjoint_kernel``, then ``ln_param_sums`` for ``d_wb``): one
    pass over the edge rows that gathers the cotangent rows itself.
    float32, every tensor contiguous; ``stats``, ``weight`` and ``bias``
    None for the norm-free stage.  Returns what ``ln_edge_adjoint_plain``
    returns; its row sums and the parameter sums (float64 block sums added
    in a fixed order) add in another order, so they differ from it by
    rounding, and repeat bit for bit."""
    if g3.device.type == "cpu":
        return ln_edge_adjoint_plain(u_idx, v_idx, d_sum_u, d_sum_v, g3,
                                     e_out, d_e_out, stats, weight, bias)
    if g3.device.type != "cuda":
        raise ValueError(f"LN edge adjoint: unsupported device {g3.device}")
    dev = g3.device
    E, d = e_out.shape
    n = d_sum_u.shape[0]
    _check("g3", g3, torch.float32, (E, 3 * d), dev)
    for name, t in (("e_out", e_out), ("d_e_out", d_e_out)):
        _check(name, t, torch.float32, (E, d), dev)
    for name, t in (("d_sum_u", d_sum_u), ("d_sum_v", d_sum_v)):
        _check(name, t, torch.float32, (n, 2 * d), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, torch.int32, (E,), dev)
    norm = weight is not None
    if not norm and (stats is not None or bias is not None):
        raise ValueError("LN edge adjoint: stats, weight and bias, or none")
    if norm:
        _check("stats", stats, torch.float32, (E, 2), dev)
        _check("weight", weight, torch.float32, (d,), dev)
        _check("bias", bias, torch.float32, (d,), dev)
    pay_u = torch.empty((E, 2 * d), dtype=torch.float32, device=dev)
    pay_v = torch.empty((E, 2 * d), dtype=torch.float32, device=dev)
    d_e = torch.empty_like(e_out)
    if E == 0:
        return (pay_u, pay_v, d_e,
                torch.zeros((2, d), dtype=torch.float32, device=dev) if norm
                else None)
    d_wb = (torch.empty((2, d), dtype=torch.float32, device=dev) if norm
            else None)
    lib = _library()
    partials = (torch.empty((lib.gn_ln_edge_adjoint_blocks(E), 2 * d),
                            dtype=torch.float64, device=dev) if norm
                else None)
    with torch.cuda.device(dev):
        rc = lib.gn_ln_edge_adjoint(
            E, d, _ptr(u_idx), _ptr(v_idx), _ptr(d_sum_u), _ptr(d_sum_v),
            _ptr(g3), _ptr(e_out), _ptr(d_e_out), _ptr(stats), _ptr(weight),
            _ptr(bias), _ptr(pay_u), _ptr(pay_v), _ptr(d_e), _ptr(partials),
            _ptr(d_wb), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "LN edge adjoint")
    _count(ln_edge_adjoint, torch.float32)
    return pay_u, pay_v, d_e, d_wb


# ------------------------------------------------------ residual BatchNorm
def bn_residual_forward_plain(a, b, weight, bias, running_mean, running_var,
                              tracked, eps: float, momentum: float):
    """Plain PyTorch residual training-mode BatchNorm over the rows of ``x
    = a + b`` ([n, d]): ``(y [n, d], x, stats [2, d])`` with ``stats`` =
    [mean | rsqrt(var + eps)], the batch mean and biased variance (two
    passes), ``y = ((x - mean) * inv) * weight + bias``; updates
    ``running_mean``, ``running_var`` (unbiased variance) at ``momentum``
    and advances ``tracked`` by 1, in place.  The operations of
    ``models/norm.batch_norm_train`` over ``a + b``."""
    x = a + b
    n = x.shape[0]
    mean = x.sum(0) / n
    var = ((x - mean) ** 2).sum(0) / n
    inv = torch.rsqrt(var + eps)
    y = ((x - mean) * inv) * weight + bias
    with torch.no_grad():
        unbiased = var * (n / (n - 1) if n > 1 else 1.0)
        running_mean.copy_((1.0 - momentum) * running_mean + momentum * mean)
        running_var.copy_((1.0 - momentum) * running_var
                          + momentum * unbiased)
        tracked.add_(1)
    return y, x, torch.stack([mean, inv])


def bn_residual_backward_plain(g, x, stats, weight):
    """Plain PyTorch adjoint of ``bn_residual_forward_plain``: ``(dx [n,
    d], dwb [2, d])`` from the output's gradient ``g`` and the forward's
    ``x`` and ``stats``, with ``xhat = (x - mean) * inv``: ``dx = (weight *
    inv) * ((g - mean(g)) - xhat * mean(g * xhat))``, the gradient of ``a``
    and of ``b`` (through the batch mean and variance), and ``dwb`` =
    [sum g * xhat | sum g], the gradients of ``weight`` and ``bias``."""
    mean, inv = stats[0], stats[1]
    n = x.shape[0]
    xhat = (x - mean) * inv
    sg, sgx = g.sum(0), (g * xhat).sum(0)
    dx = (weight * inv) * ((g - sg / n) - xhat * (sgx / n))
    return dx, torch.stack([sgx, sg])


def _bn_residual_vec(d: int, tensors) -> int:
    """1 where the kernels take 16-byte words (d a multiple of 4, every
    row pointer 16-byte aligned), else 0 (one float a thread)."""
    return int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def bn_residual_forward(a, b, weight, bias, running_mean, running_var,
                        tracked, eps: float, momentum: float):
    """The residual BatchNorm's forward (csrc/bn_residual.cu: the
    statistics kernel, its finisher, the normalise kernel) in place of the
    plain version's passes.  float32, ``a`` and ``b`` [n, d] contiguous,
    ``weight``, ``bias``, ``running_mean``, ``running_var`` [d],
    ``tracked`` an int64 scalar.  Returns what
    ``bn_residual_forward_plain`` returns, with the same updates: ``x``
    bit for bit, the statistics from float64 block sums merged in a fixed
    order (so they differ from the plain version's by rounding, and repeat
    bit for bit), ``y`` bit for bit the plain version's normalisation of
    ``x`` with them.  No rows: raises (no batch statistics)."""
    if a.shape[0] == 0:
        raise ValueError("residual BatchNorm: no rows to take batch "
                         "statistics over")
    if a.device.type == "cpu":
        return bn_residual_forward_plain(a, b, weight, bias, running_mean,
                                         running_var, tracked, eps, momentum)
    if a.device.type != "cuda":
        raise ValueError(f"residual BatchNorm: unsupported device {a.device}")
    dev = a.device
    n, d = a.shape
    for name, t in (("a", a), ("b", b)):
        _check(name, t, torch.float32, (n, d), dev)
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        _check(name, t, torch.float32, (d,), dev)
    _check("tracked", tracked, torch.int64, (), dev)
    x, y = torch.empty_like(a), torch.empty_like(a)
    stats = torch.empty((2, d), dtype=torch.float32, device=dev)
    vec = _bn_residual_vec(d, (a, b, x, y, weight, bias))
    lib = _library()
    partials = torch.empty((lib.gn_bn_residual_blocks(n, d, vec), 3 * d),
                           dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gn_bn_residual_forward(
            n, d, vec, _ptr(a), _ptr(b), _ptr(weight), _ptr(bias), eps,
            momentum, _ptr(x), _ptr(y), _ptr(stats), _ptr(running_mean),
            _ptr(running_var), _ptr(tracked), _ptr(partials),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "residual BatchNorm forward")
    _count(bn_residual_forward, torch.float32)
    return y, x, stats


def bn_residual_backward(g, x, stats, weight):
    """The residual BatchNorm's backward (csrc/bn_residual.cu: the sums
    kernel, ``reduce_partials``, the dx kernel) in place of the plain
    version's passes.  float32, ``g`` and ``x`` [n, d] contiguous,
    ``stats`` [2, d], ``weight`` [d].  Returns what
    ``bn_residual_backward_plain`` returns: the column sums are float64
    block sums added in a fixed order and rounded once (the plain version
    sums in float32), so ``dwb`` and, through the sums' means, ``dx``
    differ from it by rounding, and repeat bit for bit.  No rows: raises,
    as the forward does."""
    if x.shape[0] == 0:
        raise ValueError("residual BatchNorm: no rows (the forward takes "
                         "none)")
    if g.device.type == "cpu":
        return bn_residual_backward_plain(g, x, stats, weight)
    if g.device.type != "cuda":
        raise ValueError(f"residual BatchNorm: unsupported device {g.device}")
    dev = g.device
    n, d = x.shape
    for name, t in (("g", g), ("x", x)):
        _check(name, t, torch.float32, (n, d), dev)
    _check("stats", stats, torch.float32, (2, d), dev)
    _check("weight", weight, torch.float32, (d,), dev)
    dx = torch.empty_like(x)
    dwb = torch.empty((2, d), dtype=torch.float32, device=dev)
    sums = torch.empty(2 * d, dtype=torch.float64, device=dev)
    vec = _bn_residual_vec(d, (g, x, dx, stats, weight))
    lib = _library()
    partials = torch.empty((lib.gn_bn_residual_blocks(n, d, vec), 2 * d),
                           dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gn_bn_residual_backward(
            n, d, vec, _ptr(g), _ptr(x), _ptr(stats), _ptr(weight), _ptr(dx),
            _ptr(dwb), _ptr(sums), _ptr(partials),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "residual BatchNorm backward")
    _count(bn_residual_backward, torch.float32)
    return dx, dwb


# ------------------------------------------------------------ GAT edge work
GAT_SLOPE = 0.2         # LeakyReLU's negative slope
GAT_DENOM_MIN = 1e-9    # the softmax denominators' clamp


def gat_node_logits_plain(feat, attn_l, attn_r):
    """Plain PyTorch attention halves of the nodes: ``(el, er)`` ([N, H]),
    ``el[n, h] = <feat[n, h], attn_l[h]>`` (``feat`` [N, H d], heads side by
    side; ``attn_l``, ``attn_r`` [H, d]), the products summed by
    ``torch.sum``."""
    heads, d = attn_l.shape
    f3 = feat.view(-1, heads, d)
    return (f3 * attn_l).sum(-1), (f3 * attn_r).sum(-1)


def gat_node_logits(feat, attn_l, attn_r):
    """The attention's node halves (csrc/gat_edge.cu
    ``gat_node_logits_kernel``): one pass over ``feat`` in place of the
    plain version's two products and two sums over ``[N, H d]``.  float32,
    every tensor contiguous.  Returns what ``gat_node_logits_plain``
    returns; its dot products add in another order than ``torch.sum``, so
    they differ from it by rounding."""
    if feat.device.type == "cpu":
        return gat_node_logits_plain(feat, attn_l, attn_r)
    if feat.device.type != "cuda":
        raise ValueError(f"GAT node logits: unsupported device {feat.device}")
    dev = feat.device
    heads, d = attn_l.shape
    n = feat.shape[0]
    _gat_check("GAT node logits", dev, heads,
               [("feat", feat, (n, heads * d)), ("attn_l", attn_l, (heads, d)),
                ("attn_r", attn_r, (heads, d))], [])
    el = torch.empty((n, heads), dtype=torch.float32, device=dev)
    er = torch.empty((n, heads), dtype=torch.float32, device=dev)
    if n == 0:
        return el, er
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_gat_node_logits(
            n, heads, d, _ptr(feat), _ptr(attn_l), _ptr(attn_r), _ptr(el),
            _ptr(er), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "GAT node logits")
    _count(gat_node_logits, torch.float32)
    return el, er


def gat_node_adjoint_plain(feat, attn_l, attn_r, d_el, d_er, acc):
    """Plain PyTorch adjoint of ``gat_node_logits``: ``(d_feat [N, H d],
    d_attn [2, H, d])``, ``d_feat = acc + (d_el (x) attn_l + d_er (x)
    attn_r)`` (``acc``: feat's gradient from elsewhere, the messages')
    and ``d_attn`` = [sum over n of d_el[n, h] * feat[n, h] | the same of
    d_er], the gradients of ``attn_l`` and ``attn_r``."""
    heads, d = attn_l.shape
    f3 = feat.view(-1, heads, d)
    gl, gr = d_el[:, :, None], d_er[:, :, None]
    d_feat = acc + (gl * attn_l + gr * attn_r).reshape(acc.shape)
    return d_feat, torch.stack([(gl * f3).sum(0), (gr * f3).sum(0)])


def gat_node_adjoint(feat, attn_l, attn_r, d_el, d_er, acc):
    """The attention's node adjoint (csrc/gat_edge.cu
    ``gat_node_adjoint_kernel``, then ``reduce_partials``): one pass over
    ``feat`` and ``acc`` that writes ``d_feat`` and sums the attention
    vectors' gradients in float64 blocks added in a fixed order.  float32,
    every tensor contiguous.  Returns what ``gat_node_adjoint_plain``
    returns: ``d_feat`` bit for bit, ``d_attn`` rounded once from its
    float64 sums (the plain version sums in float32), and repeating bit for
    bit."""
    if feat.device.type == "cpu":
        return gat_node_adjoint_plain(feat, attn_l, attn_r, d_el, d_er, acc)
    if feat.device.type != "cuda":
        raise ValueError(f"GAT node adjoint: unsupported device {feat.device}")
    dev = feat.device
    heads, d = attn_l.shape
    n = feat.shape[0]
    _gat_check("GAT node adjoint", dev, heads,
               [("feat", feat, (n, heads * d)), ("attn_l", attn_l, (heads, d)),
                ("attn_r", attn_r, (heads, d)), ("d_el", d_el, (n, heads)),
                ("d_er", d_er, (n, heads)), ("acc", acc, (n, heads * d))], [])
    d_feat = torch.empty_like(acc)
    if n == 0:
        return d_feat, torch.zeros((2, heads, d), dtype=torch.float32,
                                   device=dev)
    lib = _library()
    partials = torch.empty((lib.gn_gat_node_adjoint_blocks(n),
                            2 * heads * d), dtype=torch.float64, device=dev)
    d_attn = torch.empty(2 * heads * d, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gn_gat_node_adjoint(
            n, heads, d, _ptr(feat), _ptr(attn_l), _ptr(attn_r), _ptr(d_el),
            _ptr(d_er), _ptr(acc), _ptr(d_feat), _ptr(partials),
            _ptr(d_attn), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "GAT node adjoint")
    _count(gat_node_adjoint, torch.float32)
    return d_feat, d_attn.view(2, heads, d).float()


def gat_edge_softmax_plain(src, dst, el, er):
    """Plain PyTorch edge softmax numerators: ``expv [E, H] = exp(x -
    max_v x)`` with ``x = leaky_relu(el[src] + er[dst], 0.2)`` and the max
    over each dst's in-slots (``el``, ``er`` [N, H]; ``src``, ``dst`` [E]
    in slot order).  The max is detached and exact in any order; a node
    with no in-slot keeps 0 (JAX zoo.py:266)."""
    n, heads = er.shape
    x = torch.nn.functional.leaky_relu(el.index_select(0, src)
                                       + er.index_select(0, dst), GAT_SLOPE)
    with torch.no_grad():
        idx = dst.long()[:, None].expand(-1, heads)
        seg_max = x.new_zeros(n, heads).scatter_reduce(
            0, idx, x, "amax", include_self=False)
    return torch.exp(x - seg_max.index_select(0, dst))


def _gat_check(name, dev, heads, tensors, idx):
    """Float32 contiguous ``(name, tensor, shape)`` triples on ``dev`` and
    int32 [E] index arrays."""
    for what, t, shape in tensors:
        _check(what, t, torch.float32, shape, dev)
    for what, t, E in idx:
        _check(what, t, torch.int32, (E,), dev)
    if heads <= 0:
        raise ValueError(f"{name}: no heads")


def gat_edge_softmax(src, dst, dst_ptr, el, er):
    """The GAT edge softmax's numerators (csrc/gat_edge.cu
    ``gat_edge_softmax_kernel``): one walk of each dst's in-slots (``dst_ptr``
    [N+1], ``DeviceGraph.dst_ptr``) in place of the plain version's gathers,
    scatter max and elementwise passes.  float32, every tensor contiguous.
    Returns what ``gat_edge_softmax_plain`` returns (exp may differ by an
    ulp)."""
    if el.device.type == "cpu":
        return gat_edge_softmax_plain(src, dst, el, er)
    if el.device.type != "cuda":
        raise ValueError(f"GAT edge softmax: unsupported device {el.device}")
    dev = el.device
    E, (m, heads) = src.shape[0], er.shape
    n = dst_ptr.shape[0] - 1
    _gat_check("GAT edge softmax", dev, heads,
               [("el", el, (el.shape[0], heads)), ("er", er, (m, heads))],
               [("src", src, E), ("dst", dst, E), ("dst_ptr", dst_ptr, n + 1)])
    expv = torch.empty((E, heads), dtype=torch.float32, device=dev)
    if E == 0:
        return expv
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_gat_edge_softmax(
            n, heads, _ptr(dst_ptr), _ptr(src), _ptr(el), _ptr(er),
            _ptr(expv), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "GAT edge softmax")
    _count(gat_edge_softmax, torch.float32)
    return expv


def gat_messages_plain(src, dst, feat, expv, denom):
    """Plain PyTorch GAT messages: ``(msg [E, H d], alpha [E, H])`` with
    ``alpha = expv / max(denom[dst], 1e-9)`` and ``msg`` = ``feat[src]``
    ([N, H d], heads side by side) weighted head by head by ``alpha``."""
    heads = expv.shape[1]
    alpha = expv / denom.index_select(0, dst).clamp_min(GAT_DENOM_MIN)
    rows = feat.index_select(0, src)
    msg = rows.view(-1, heads, rows.shape[1] // heads) * alpha[:, :, None]
    return msg.reshape(rows.shape), alpha


def gat_messages(src, dst, feat, expv, denom):
    """The GAT messages (csrc/gat_edge.cu ``gat_messages_kernel``): one pass
    that gathers ``feat[src]`` and writes ``msg`` and ``alpha`` in place of
    the plain version's gathers, clamp, division and weighting.  float32,
    every tensor contiguous.  Returns what ``gat_messages_plain`` returns,
    bit for bit."""
    if feat.device.type == "cpu":
        return gat_messages_plain(src, dst, feat, expv, denom)
    if feat.device.type != "cuda":
        raise ValueError(f"GAT messages: unsupported device {feat.device}")
    dev = feat.device
    E, heads = expv.shape
    w = feat.shape[1]
    if w % heads:
        raise ValueError(f"GAT messages: width {w} not a multiple of "
                         f"{heads} heads")
    _gat_check("GAT messages", dev, heads,
               [("feat", feat, (feat.shape[0], w)), ("expv", expv, (E, heads)),
                ("denom", denom, (denom.shape[0], heads))],
               [("src", src, E), ("dst", dst, E)])
    msg = torch.empty((E, w), dtype=torch.float32, device=dev)
    alpha = torch.empty((E, heads), dtype=torch.float32, device=dev)
    if E == 0:
        return msg, alpha
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_gat_messages(
            E, heads, w // heads, _ptr(src), _ptr(dst), _ptr(feat),
            _ptr(expv), _ptr(denom), _ptr(msg), _ptr(alpha),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "GAT messages")
    _count(gat_messages, torch.float32)
    return msg, alpha


def gat_message_adjoint_plain(src, dst, d_out, feat, alpha, denom):
    """Plain PyTorch adjoint of the GAT messages and of their sum into dst:
    ``(d_feat [E, H d], d_expv [E, H], pay [E, H])`` from the cotangent
    ``d_out`` [N, H d] of the sums, gathered here at ``dst``: ``d_feat =
    alpha * d_out[dst]`` head by head (summed into src it is feat's
    gradient), ``d_alpha = <d_out[dst], feat[src]>`` a head, ``d_expv =
    d_alpha / Dc`` and ``pay = -d_alpha * (alpha / Dc)`` where ``denom[dst]
    >= 1e-9``, else 0 (``Dc = max(denom[dst], 1e-9)``; summed into dst it
    is the denominators' gradient): autograd's adjoints of the division and
    the clamp, in their operations."""
    heads = alpha.shape[1]
    g = d_out.index_select(0, dst)
    g3 = g.view(-1, heads, g.shape[1] // heads)
    d_feat = (g3 * alpha[:, :, None]).reshape(g.shape)
    rows = feat.index_select(0, src)
    d_alpha = (g3 * rows.view(g3.shape)).sum(-1)
    den = denom.index_select(0, dst)
    dc = den.clamp_min(GAT_DENOM_MIN)
    pay = torch.where(den >= GAT_DENOM_MIN, -d_alpha * (alpha / dc),
                      torch.zeros_like(d_alpha))
    return d_feat, d_alpha / dc, pay


def gat_message_adjoint(src, dst, d_out, feat, alpha, denom):
    """The GAT messages' adjoint (csrc/gat_edge.cu
    ``gat_message_adjoint_kernel``): one pass over the slots that gathers
    ``d_out[dst]`` and ``feat[src]`` itself.  float32, every tensor
    contiguous.  Returns what ``gat_message_adjoint_plain`` returns;
    ``d_alpha``'s dot products add in another order than ``torch.sum``, so
    ``d_expv`` and ``pay`` differ from it by rounding; ``d_feat`` is bit
    for bit."""
    if feat.device.type == "cpu":
        return gat_message_adjoint_plain(src, dst, d_out, feat, alpha, denom)
    if feat.device.type != "cuda":
        raise ValueError(f"GAT message adjoint: unsupported device "
                         f"{feat.device}")
    dev = feat.device
    E, heads = alpha.shape
    w = feat.shape[1]
    if w % heads:
        raise ValueError(f"GAT message adjoint: width {w} not a multiple of "
                         f"{heads} heads")
    n = denom.shape[0]
    _gat_check("GAT message adjoint", dev, heads,
               [("d_out", d_out, (n, w)), ("feat", feat, (feat.shape[0], w)),
                ("alpha", alpha, (E, heads)), ("denom", denom, (n, heads))],
               [("src", src, E), ("dst", dst, E)])
    d_feat = torch.empty((E, w), dtype=torch.float32, device=dev)
    d_expv = torch.empty((E, heads), dtype=torch.float32, device=dev)
    pay = torch.empty((E, heads), dtype=torch.float32, device=dev)
    if E == 0:
        return d_feat, d_expv, pay
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_gat_message_adjoint(
            E, heads, w // heads, _ptr(src), _ptr(dst), _ptr(d_out),
            _ptr(feat), _ptr(alpha), _ptr(denom), _ptr(d_feat), _ptr(d_expv),
            _ptr(pay), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "GAT message adjoint")
    _count(gat_message_adjoint, torch.float32)
    return d_feat, d_expv, pay


def gat_logit_adjoint_plain(src, dst, el, er, expv, d_expv, d_denom):
    """Plain PyTorch adjoint of the edge softmax's numerators: ``d_x [E,
    H]``, the cotangent of ``el[src] + er[dst]`` (summed into src it is
    el's gradient, into dst er's): ``(d_expv + d_denom[dst]) * expv``
    (exp's adjoint; the max left out), times 0.2 where ``el[src] +
    er[dst]`` is not positive (LeakyReLU's)."""
    x = el.index_select(0, src) + er.index_select(0, dst)
    de = (d_expv + d_denom.index_select(0, dst)) * expv
    return torch.where(x > 0, de, de * GAT_SLOPE)


def gat_logit_adjoint(src, dst, el, er, expv, d_expv, d_denom):
    """The edge softmax's adjoint (csrc/gat_edge.cu
    ``gat_logit_adjoint_kernel``): one pass over the slots in place of the
    plain version's gathers and elementwise passes.  float32, every tensor
    contiguous.  Returns what ``gat_logit_adjoint_plain`` returns, bit for
    bit."""
    if el.device.type == "cpu":
        return gat_logit_adjoint_plain(src, dst, el, er, expv, d_expv,
                                       d_denom)
    if el.device.type != "cuda":
        raise ValueError(f"GAT logit adjoint: unsupported device {el.device}")
    dev = el.device
    E, heads = expv.shape
    _gat_check("GAT logit adjoint", dev, heads,
               [("el", el, (el.shape[0], heads)),
                ("er", er, (er.shape[0], heads)), ("expv", expv, (E, heads)),
                ("d_expv", d_expv, (E, heads)),
                ("d_denom", d_denom, (d_denom.shape[0], heads))],
               [("src", src, E), ("dst", dst, E)])
    d_x = torch.empty((E, heads), dtype=torch.float32, device=dev)
    if E == 0:
        return d_x
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_gat_logit_adjoint(
            E, heads, _ptr(src), _ptr(dst), _ptr(el), _ptr(er), _ptr(expv),
            _ptr(d_expv), _ptr(d_denom), _ptr(d_x),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "GAT logit adjoint")
    _count(gat_logit_adjoint, torch.float32)
    return d_x


# ------------------------------------------------- GraphGPS global attention
GPS_HEAD_WIDTH = 16     # the kernels' head width (GraphGPS's 64 / 4 heads)
GPS_TILE = 128          # rows a CTA owns: 64 threads of 2 rows
GPS_KEY_TILE = 256      # the backward's keys a CTA a pass: 4 warps of 64
GPS_BWD_FILL = 256      # backward CTAs that fill an H100: 2 an SM of 132
GPS_BWD_SPLITS = 32     # the most key ranges a unit and head is cut into
GPS_COL_SALT = 0x9E3779B9
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c`` mod 2**32 for ``x`` in [0, 2**32) (an int64 tensor or an
    int) and a constant ``c`` < 2**32, in products below 2**48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """The attention dropout's 32-bit mix (csrc/gps_attention.cu
    ``mix32``): ``x ^= x >> 16; x *= 0x7feb352d; x ^= x >> 15; x *=
    0x846ca68b``, mod 2**32, on int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    return _mul32(x, 0x846CA68B)


def attention_keep_threshold(rate: float) -> int:
    """The keep test's bound: a pair is kept where its 32-bit hash is below
    ``round((1 - rate) * 2**32)`` (2**31 at rate 0.5)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout {rate}: expected 0 <= rate < 1")
    return min(int(round((1.0 - rate) * 2 ** 32)), _M32)


def attention_keep_plain(seed: int, layer: int, heads: int, n_rows: int,
                         n_cols: int, rate: float,
                         device="cpu") -> torch.Tensor:
    """The attention dropout's keep mask ``[heads, n_rows, n_cols]`` (bool)
    of one unit for its ``layer`` from the 64-bit ``seed``, rows and
    columns unit-relative query and key rows: ``base = mix(mix(seed_hi) ^
    seed_lo)``, ``stream = mix(base ^ (layer * heads + head))``, ``row(q) =
    mix(stream ^ q)``, ``col(k) = mix(k ^ 0x9e3779b9)``, kept where
    ``mix(row(q) ^ col(k))`` < ``attention_keep_threshold(rate)``.  A pure
    function of its arguments: the kernels compute the same bits.  The
    mask is made on ``device``."""
    seed &= (1 << 64) - 1
    base = _mix32(_mix32(seed >> 32) ^ (seed & _M32))
    i64 = dict(dtype=torch.int64, device=device)
    streams = _mix32(base ^ torch.arange(layer * heads, (layer + 1) * heads,
                                         **i64))
    rows = _mix32(streams[:, None] ^ torch.arange(n_rows, **i64)[None, :])
    cols = _mix32(torch.arange(n_cols, **i64) ^ GPS_COL_SALT)
    return _mix32(rows[:, :, None] ^ cols[None, None, :]) < \
        attention_keep_threshold(rate)


class AttentionSegments:
    """The units (graphs) of a batch for the block-diagonal attention:
    ``ptr`` (host int64 [B+1], the node offsets, ``ptr[0] = 0``,
    ``ptr[-1] = N``) and, on ``device``, the forward's ``tiles`` (int32
    [T, 4], one row ``(r0, r1, u0, u1)`` a CTA: rows ``[r0, r1)``, at most
    ``GPS_TILE``, of the unit ``[u0, u1)``) and the backward's
    ``bwd_units`` (int32 [U, 2], one row ``(u0, u1)`` a unit: every
    non-empty unit once, largest first, ties in batch order), both built
    once per batch so that no launch copies from the host."""

    def __init__(self, graph_ptr, device):
        ptr = np.asarray(graph_ptr, dtype=np.int64)
        if (ptr.ndim != 1 or ptr.size < 2 or ptr[0] != 0
                or np.any(np.diff(ptr) < 0)):
            raise ValueError(f"graph_ptr {ptr!r}: expected ascending node "
                             "offsets from 0")
        if ptr[-1] >= 2 ** 31:
            raise ValueError(f"{ptr[-1]} nodes: int32 row indices")
        self.ptr = ptr
        self.n_nodes = int(ptr[-1])
        rows = []
        for u0, u1 in zip(ptr[:-1], ptr[1:]):
            for r0 in range(int(u0), int(u1), GPS_TILE):
                rows.append((r0, min(r0 + GPS_TILE, int(u1)), u0, u1))
        self.tiles = torch.as_tensor(np.asarray(rows, dtype=np.int32)
                                     .reshape(-1, 4), device=device)
        sizes = np.diff(ptr)
        order = np.argsort(-sizes, kind="stable")
        order = order[sizes[order] > 0]
        self.bwd_units = torch.as_tensor(
            np.stack([ptr[order], ptr[order + 1]], axis=1).astype(np.int32),
            device=device)
        self.bwd_max_rows = int(sizes.max(initial=0))

    def bwd_splits(self, heads: int) -> int:
        """The key ranges the backward cuts each unit and head into: 1
        where the units and heads fill the card (``GPS_BWD_FILL`` CTAs),
        else as many as fill it, at most ``GPS_BWD_SPLITS`` and the largest
        unit's key tiles.  A function of the lengths alone, so two runs of
        a batch add dQ in the same order."""
        ctas = self.bwd_units.shape[0] * heads
        if ctas == 0 or ctas >= GPS_BWD_FILL:
            return 1
        tiles = -(-self.bwd_max_rows // GPS_KEY_TILE)
        return min(-(-GPS_BWD_FILL // ctas), GPS_BWD_SPLITS, tiles)

    def units(self):
        """``(u0, u1)`` of every unit."""
        return zip(self.ptr[:-1].tolist(), self.ptr[1:].tolist())


def _heads_of(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``[n, heads * w]`` as ``[heads, n, w]``."""
    return t.reshape(t.shape[0], heads, -1).transpose(0, 1)


def gps_attention_forward_plain(qkv, seg: AttentionSegments, seed, layer: int,
                                heads: int, rate: float):
    """Plain PyTorch block-diagonal attention, unit by unit: ``(out [N, d],
    lse [N, heads])`` from ``qkv`` [N, 3d] = ``[q | k | v]`` (heads side by
    side in each), ``out`` of a unit's row ``q`` = ``sum_k drop(softmax(q .
    k / sqrt(w)))_k v_k`` over the unit's keys, ``drop`` the keep mask of
    ``attention_keep_plain`` scaled by ``1 / (1 - rate)`` (none at rate 0),
    ``lse`` the natural log of the softmax's sum (``seed``: an int64
    tensor of one element)."""
    d = qkv.shape[1] // 3
    scale = (d // heads) ** -0.5
    out = qkv.new_empty((qkv.shape[0], d))
    lse = qkv.new_empty((qkv.shape[0], heads))
    seed = int(seed.reshape(-1)[0]) if rate > 0.0 else 0
    for u0, u1 in seg.units():
        if u1 == u0:
            continue
        q, k, v = (_heads_of(qkv[u0:u1, j * d:(j + 1) * d], heads)
                   for j in range(3))
        s = (q @ k.transpose(1, 2)) * scale
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        z = p.sum(-1, keepdim=True)
        p = p / z
        if rate > 0.0:
            keep = attention_keep_plain(seed, layer, heads, u1 - u0, u1 - u0,
                                        rate, qkv.device)
            p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
        out[u0:u1] = (p @ v).transpose(0, 1).reshape(u1 - u0, d)
        lse[u0:u1] = (m + torch.log(z))[:, :, 0].t()
    return out, lse


def gps_attention_backward_plain(qkv, out, lse, d_out, seg: AttentionSegments,
                                 seed, layer: int, heads: int, rate: float):
    """Plain PyTorch adjoint of ``gps_attention_forward_plain``: ``d_qkv``
    [N, 3d] from ``d_out`` [N, d], recomputing each unit's probabilities
    from ``lse``: ``dP~ = dO V^T``, ``dS = P (drop(dP~) - D)`` with ``D =
    rowsum(dO * O)``, ``dQ = dS K / sqrt(w)``, ``dK = dS^T Q / sqrt(w)``,
    ``dV = drop(P)^T dO``."""
    d = qkv.shape[1] // 3
    scale = (d // heads) ** -0.5
    d_qkv = qkv.new_empty(qkv.shape)
    seed = int(seed.reshape(-1)[0]) if rate > 0.0 else 0
    for u0, u1 in seg.units():
        if u1 == u0:
            continue
        q, k, v = (_heads_of(qkv[u0:u1, j * d:(j + 1) * d], heads)
                   for j in range(3))
        do, o = _heads_of(d_out[u0:u1], heads), _heads_of(out[u0:u1], heads)
        p = torch.exp((q @ k.transpose(1, 2)) * scale
                      - lse[u0:u1].t()[:, :, None])
        dp = do @ v.transpose(1, 2)
        pd = p
        if rate > 0.0:
            keep = attention_keep_plain(seed, layer, heads, u1 - u0, u1 - u0,
                                        rate, qkv.device)
            zero = torch.zeros_like(p)
            pd = torch.where(keep, p / (1.0 - rate), zero)
            dp = torch.where(keep, dp / (1.0 - rate), zero)
        ds = p * (dp - (do * o).sum(-1, keepdim=True))
        grads = ((ds @ k) * scale, (ds.transpose(1, 2) @ q) * scale,
                 pd.transpose(1, 2) @ do)
        for j, gr in enumerate(grads):
            d_qkv[u0:u1, j * d:(j + 1) * d] = gr.transpose(0, 1).reshape(
                u1 - u0, d)
    return d_qkv


def _gps_check(qkv, seg: AttentionSegments, heads: int, rate: float):
    n, d3 = qkv.shape
    d = d3 // 3
    if d3 != 3 * d or d != heads * GPS_HEAD_WIDTH:
        raise ValueError(f"GraphGPS attention: qkv [{n}, {d3}] with {heads} "
                         f"heads; the kernels take heads of "
                         f"{GPS_HEAD_WIDTH} (qkv [N, 3 * heads * "
                         f"{GPS_HEAD_WIDTH}])")
    if seg.n_nodes != n:
        raise ValueError(f"GraphGPS attention: segments over {seg.n_nodes} "
                         f"nodes, qkv has {n} rows")
    _check("qkv", qkv, torch.float32, (n, d3), qkv.device)
    if seg.tiles.device != qkv.device:
        raise ValueError(f"segments on {seg.tiles.device}, qkv on "
                         f"{qkv.device}")
    return n, d, attention_keep_threshold(rate)


def gps_attention_forward(qkv, seg: AttentionSegments, seed, layer: int,
                          heads: int, rate: float):
    """The block-diagonal attention's forward (csrc/gps_attention.cu
    ``gps_attn_fwd``: an online softmax per query row and head over its
    unit's keys, dropout inside) in place of the plain version.  float32,
    ``qkv`` [N, 3d] contiguous, heads of ``GPS_HEAD_WIDTH``, ``seed`` an
    int64 tensor of one element on the device (read there: no host
    synchronisation).  Returns what ``gps_attention_forward_plain``
    returns, equal to it up to rounding (another order of the sums, exp2
    in place of exp), and nothing ``[n, n]`` is stored."""
    if qkv.device.type == "cpu":
        return gps_attention_forward_plain(qkv, seg, seed, layer, heads, rate)
    if qkv.device.type != "cuda":
        raise ValueError(f"GraphGPS attention: unsupported device "
                         f"{qkv.device}")
    dev = qkv.device
    n, d, keep_below = _gps_check(qkv, seg, heads, rate)
    if rate > 0.0:
        _check("seed", seed, torch.int64, (1,), dev)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    lse = torch.empty((n, heads), dtype=torch.float32, device=dev)
    if n == 0:
        return out, lse
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_gps_attention_forward(
            seg.tiles.shape[0], heads, _ptr(qkv), _ptr(seg.tiles),
            _ptr(seed), layer, int(rate > 0.0), keep_below,
            1.0 / (1.0 - rate), _ptr(out),
            _ptr(lse), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "GraphGPS attention forward")
    _count(gps_attention_forward, torch.float32)
    return out, lse


def gps_attention_backward(qkv, out, lse, d_out, seg: AttentionSegments, seed,
                           layer: int, heads: int, rate: float):
    """The block-diagonal attention's backward (csrc/gps_attention.cu), two
    launches: ``gps_attn_bwd_rowdot`` writes ``D = rowsum(dO * O)`` a row
    and head into the scratch ``[N, heads]``; ``gps_attn_bwd``, one CTA a
    unit, head and key range (``seg.bwd_units``, largest first;
    ``seg.bwd_splits`` ranges, 1 where the units fill the card), visits
    each (query, key) pair once, recomputing ``p`` from ``lse`` and the
    dropout bit from the seed, and accumulates dV and dK of its keys in
    registers and dQ of its queries in a fixed order (each warp's ``ds K``
    in key order through shared memory, the warps in order, key tile after
    key tile into ``d_qkv``; where a unit's keys are cut into ranges, the
    later ranges into a scratch ``[(splits - 1) N, d]`` that the range to
    finish last adds in range order): nothing is added atomically, so two
    runs agree bit for bit.  float32, every tensor contiguous.  Returns
    what ``gps_attention_backward_plain`` returns, equal up to rounding."""
    if qkv.device.type == "cpu":
        return gps_attention_backward_plain(qkv, out, lse, d_out, seg, seed,
                                            layer, heads, rate)
    if qkv.device.type != "cuda":
        raise ValueError(f"GraphGPS attention: unsupported device "
                         f"{qkv.device}")
    dev = qkv.device
    n, d, keep_below = _gps_check(qkv, seg, heads, rate)
    if rate > 0.0:
        _check("seed", seed, torch.int64, (1,), dev)
    for name, t, shape in (("out", out, (n, d)), ("d_out", d_out, (n, d)),
                           ("lse", lse, (n, heads))):
        _check(name, t, torch.float32, shape, dev)
    d_qkv = torch.empty_like(qkv)
    if n == 0:
        return d_qkv
    dvec = torch.empty((n, heads), dtype=torch.float32, device=dev)
    units, splits = seg.bwd_units.shape[0], seg.bwd_splits(heads)
    part = tickets = None
    if splits > 1:
        # dQ of each unit's later key ranges; a ticket a unit and head,
        # zeroed by the first launch
        part = torch.empty(((splits - 1) * n, d), dtype=torch.float32,
                           device=dev)
        tickets = torch.empty(units * heads, dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_gps_attention_backward(
            n, units, heads, splits, _ptr(qkv), _ptr(seg.bwd_units),
            _ptr(seed), layer, int(rate > 0.0), keep_below,
            1.0 / (1.0 - rate), _ptr(out),
            _ptr(d_out), _ptr(lse), _ptr(dvec), _ptr(d_qkv), _ptr(part),
            _ptr(tickets), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "GraphGPS attention backward")
    _count(gps_attention_backward, torch.float32)
    return d_qkv


# ------------------------------------------------------------ launch counting
KERNELS = {"k1_gather_gate": k1_gather_gate, "k2_aggregate": k2_aggregate,
           "k2_side_sum": k2_side_sum, "k3_edge_stage": k3_edge_stage, "k6_score_gate": k6_score_gate,
           "k7_gate_stats": k7_gate_stats,
           "k8_train_layer_bwd": k8_train_layer_bwd,
           "k9_aggregate": k9_aggregate, "bn_edge_adjoint": bn_edge_adjoint,
           "ln_edge_stage": ln_edge_stage, "ln_edge_adjoint": ln_edge_adjoint,
           "gat_node_logits": gat_node_logits,
           "gat_edge_softmax": gat_edge_softmax, "gat_messages": gat_messages,
           "gat_message_adjoint": gat_message_adjoint,
           "gat_logit_adjoint": gat_logit_adjoint,
           "gat_node_adjoint": gat_node_adjoint,
           "bn_residual_forward": bn_residual_forward,
           "bn_residual_backward": bn_residual_backward,
           "gps_attention_forward": gps_attention_forward,
           "gps_attention_backward": gps_attention_backward}
for _fn in KERNELS.values():
    _fn.launches = _fn.launches_bf16 = 0


def launch_counts(dtype: torch.dtype | None = None) -> dict:
    """Each kernel's launches since the last reset: all of them, or
    (``dtype``) those of its float32 or its bfloat16 instantiation."""
    if dtype is None:
        return {name: fn.launches for name, fn in KERNELS.items()}
    if dtype == torch.bfloat16:
        return {name: fn.launches_bf16 for name, fn in KERNELS.items()}
    if dtype == torch.float32:
        return {name: fn.launches - fn.launches_bf16
                for name, fn in KERNELS.items()}
    raise ValueError(f"dtype={dtype}: expected None, torch.float32 or "
                     "torch.bfloat16")


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = fn.launches_bf16 = 0
