"""Hand-written CUDA kernels K3 and K6, their plain PyTorch versions, and the
build that turns ``csrc/*.cu`` into one shared library.

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
SOURCES = ("k3_edge_stage.cu", "k6_score_gate.cu")
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
    return any(os.path.getmtime(os.path.join(CSRC_DIR, s)) > t for s in SOURCES)


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
            lib.gn_k3_edge_stage.restype = I
            lib.gn_k3_edge_stage.argtypes = [
                I, I, P, P, P, P, P, P,      # n_nodes, d, v_ptr, v_perm, u_ptr, u_perm, u_idx, v_idx
                P, L, P, L,                  # proj_u, ldu, proj_v, ldv
                P, P, P,                     # b3e, e_in, bn
                P, P, P, P]                  # e_out, sum_v, sum_u, stream
            lib.gn_k6_score_gate.restype = I
            lib.gn_k6_score_gate.argtypes = [L, I, P, P, P, P, P, P]
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().gn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


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
    ``u_csr`` = ``(ptr [N+1], perm [E] or None)`` list each node's slots in
    the v / u role (``DeviceGraph.roles``).  Returns what
    ``k3_edge_stage_plain`` returns."""
    if proj_u.device.type == "cpu":
        return k3_edge_stage_plain(u_idx, v_idx, proj_u, proj_v, b3e, e_in,
                                   bn)
    if proj_u.device.type != "cuda":
        raise ValueError(f"K3: unsupported device {proj_u.device}")
    dev = proj_u.device
    E, d = b3e.shape
    n = proj_u.shape[0]
    f32, i32 = torch.float32, torch.int32
    if d > 128:
        raise ValueError(f"K3: d={d} > 128 not supported")
    _check("proj_u", proj_u, f32, (n, 2 * d), dev, rows_contiguous=False)
    _check("proj_v", proj_v, f32, (n, 2 * d), dev, rows_contiguous=False)
    for name, t in (("b3e", b3e), ("e_in", e_in)):
        _check(name, t, f32, (E, d), dev)
    _check("bn", bn, f32, (4, d), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, i32, (E,), dev)
    for side, (ptr, perm) in (("v", v_csr), ("u", u_csr)):
        _check(f"{side}_ptr", ptr, i32, (n + 1,), dev)
        if perm is not None:
            _check(f"{side}_perm", perm, i32, (E,), dev)
    e_out = torch.empty_like(b3e)
    sum_v = torch.empty((n, 2 * d), dtype=f32, device=dev)
    sum_u = torch.empty((n, 2 * d), dtype=f32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k3_edge_stage(
            n, d, _ptr(v_csr[0]), _ptr(v_csr[1]), _ptr(u_csr[0]),
            _ptr(u_csr[1]), _ptr(u_idx), _ptr(v_idx),
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
    """K6, the fused score-predictor first layer (csrc/k6_score_gate.cu)."""
    if puv.device.type == "cpu":
        return k6_score_gate_plain(u_idx, v_idx, puv, be)
    if puv.device.type != "cuda":
        raise ValueError(f"K6: unsupported device {puv.device}")
    dev = puv.device
    E, H = be.shape
    f32, i32 = torch.float32, torch.int32
    _check("puv", puv, f32, (puv.shape[0], 2 * H), dev)
    _check("be", be, f32, (E, H), dev)
    for name, t in (("u_idx", u_idx), ("v_idx", v_idx)):
        _check(name, t, i32, (E,), dev)
    z = torch.empty_like(be)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gn_k6_score_gate(E, H, _ptr(u_idx), _ptr(v_idx), _ptr(puv),
                                  _ptr(be), _ptr(z),
                                  torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K6")
    k6_score_gate.launches += 1
    return z


# ------------------------------------------------------------ launch counting
KERNELS = {"k3_edge_stage": k3_edge_stage, "k6_score_gate": k6_score_gate}
for _fn in KERNELS.values():
    _fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
