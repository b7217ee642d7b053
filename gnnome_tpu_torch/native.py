"""ctypes bridge to the C++ host support library (csrc/host/gnnome_native.cpp).

Auto-builds ``libgnnome_host.so`` with g++ on first use into ``build/`` at the
repository root (rebuilt when the source is newer); every entry point has a
pure-Python/numpy fallback so the framework degrades gracefully where no
compiler exists.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "csrc", "host", "gnnome_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
_SO_PATH = os.path.join(_BUILD_DIR, "libgnnome_host.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    if not os.path.isfile(_SRC):
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread", _SRC, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, _SO_PATH)    # atomic: concurrent loaders never see
        return True                  # a half-written library
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def get_lib():
    """Load (building if necessary) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.isfile(_SO_PATH) or (
            os.path.isfile(_SRC)
            and os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None

        lib.gn_edit_distance.restype = ctypes.c_int64
        lib.gn_edit_distance.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        lib.gn_overlap_edit_distance_batch.restype = None
        lib.gn_overlap_edit_distance_batch.argtypes = [
            ctypes.c_char_p,                     # blob
            np.ctypeslib.ndpointer(np.int64),    # offsets
            np.ctypeslib.ndpointer(np.int32),    # src
            np.ctypeslib.ndpointer(np.int32),    # dst
            np.ctypeslib.ndpointer(np.int64),    # ol
            ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64),    # out
        ]
        lib.gn_overlap_edit_distance_batch_capped.restype = None
        lib.gn_overlap_edit_distance_batch_capped.argtypes = [
            ctypes.c_char_p,                     # blob
            np.ctypeslib.ndpointer(np.int64),    # offsets
            np.ctypeslib.ndpointer(np.int32),    # src
            np.ctypeslib.ndpointer(np.int32),    # dst
            np.ctypeslib.ndpointer(np.int64),    # ol
            ctypes.c_int64, ctypes.c_int32,
            ctypes.c_double,                     # max_k_frac (0 = exact)
            np.ctypeslib.ndpointer(np.int64),    # out
        ]
        lib.gn_greedy_walk.restype = ctypes.c_int64
        lib.gn_greedy_walk.argtypes = [
            np.ctypeslib.ndpointer(np.int64),    # row_ptr
            np.ctypeslib.ndpointer(np.int32),    # col
            np.ctypeslib.ndpointer(np.int64),    # eid
            np.ctypeslib.ndpointer(np.float32),  # log_probs
            np.ctypeslib.ndpointer(np.uint8),    # visited
            np.ctypeslib.ndpointer(np.int32),    # stamp
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_float,      # use_early_stop, log_p_threshold
            np.ctypeslib.ndpointer(np.int32),    # out_walk
            ctypes.POINTER(ctypes.c_double),     # sum_log_prob
        ]
        lib.gn_greedy_walk_batch.restype = None
        lib.gn_greedy_walk_batch.argtypes = [
            np.ctypeslib.ndpointer(np.int64),    # row_ptr
            np.ctypeslib.ndpointer(np.int32),    # col
            np.ctypeslib.ndpointer(np.int64),    # eid
            np.ctypeslib.ndpointer(np.float32),  # log_probs
            np.ctypeslib.ndpointer(np.uint8),    # visited
            ctypes.c_int64,                      # n_nodes
            np.ctypeslib.ndpointer(np.int32),    # seed_src
            np.ctypeslib.ndpointer(np.int32),    # seed_dst
            ctypes.c_int64, ctypes.c_int64,      # n_cand, max_walk
            ctypes.c_int32, ctypes.c_float,      # use_early_stop, threshold
            ctypes.c_int32,                      # n_threads
            np.ctypeslib.ndpointer(np.int32),    # out_walks
            np.ctypeslib.ndpointer(np.int64),    # out_lens
            np.ctypeslib.ndpointer(np.float64),  # out_slp
        ]
        lib.gn_decode_round.restype = ctypes.c_int64
        lib.gn_decode_round.argtypes = [
            np.ctypeslib.ndpointer(np.int64),    # row_ptr
            np.ctypeslib.ndpointer(np.int32),    # col
            np.ctypeslib.ndpointer(np.int64),    # eid
            np.ctypeslib.ndpointer(np.float32),  # log_probs
            np.ctypeslib.ndpointer(np.int64),    # prefix_len (clamped)
            np.ctypeslib.ndpointer(np.int64),    # read_len
            np.ctypeslib.ndpointer(np.uint8),    # visited
            ctypes.c_int64,                      # n_nodes
            np.ctypeslib.ndpointer(np.int32),    # seed_src
            np.ctypeslib.ndpointer(np.int32),    # seed_dst
            ctypes.c_int64,                      # n_cand
            ctypes.c_int32, ctypes.c_float,      # use_early_stop, threshold
            ctypes.c_int32,                      # n_threads
            np.ctypeslib.ndpointer(np.int32),    # stamp scratch (persistent)
            np.ctypeslib.ndpointer(np.int32),    # walk scratch (persistent)
            ctypes.c_int32,                      # epoch_base
            np.ctypeslib.ndpointer(np.int32),    # out_walk
            ctypes.POINTER(ctypes.c_int64),      # out_contig_len
            ctypes.POINTER(ctypes.c_double),     # out_slp
        ]
        lib.gn_sample_seed_edges.restype = ctypes.c_int64
        lib.gn_sample_seed_edges.argtypes = [
            np.ctypeslib.ndpointer(np.int32),    # src
            np.ctypeslib.ndpointer(np.int32),    # dst
            np.ctypeslib.ndpointer(np.float32),  # probs
            np.ctypeslib.ndpointer(np.uint8),    # visited
            ctypes.c_int64,                      # n_edges
            np.ctypeslib.ndpointer(np.float64),  # uniforms
            ctypes.c_int64, ctypes.c_int32,      # k, n_threads
            np.ctypeslib.ndpointer(np.int64),    # out seeds
        ]
        lib.gn_absorb_walk.restype = ctypes.c_int64
        lib.gn_absorb_walk.argtypes = [
            np.ctypeslib.ndpointer(np.int64),    # csr_ptr
            np.ctypeslib.ndpointer(np.int32),    # csr_col
            np.ctypeslib.ndpointer(np.int64),    # csc_ptr
            np.ctypeslib.ndpointer(np.int32),    # csc_row
            np.ctypeslib.ndpointer(np.int32),    # walk
            ctypes.c_int64,                      # walk_len
            np.ctypeslib.ndpointer(np.uint8),    # visited (mutated)
            np.ctypeslib.ndpointer(np.int32),    # stamp (persistent, mutated)
            ctypes.c_int32,                      # epoch_base
            np.ctypeslib.ndpointer(np.int32),    # out_newly
        ]
        lib.gn_sampler_init.restype = None
        lib.gn_sampler_init.argtypes = [
            np.ctypeslib.ndpointer(np.int32),    # src
            np.ctypeslib.ndpointer(np.int32),    # dst
            np.ctypeslib.ndpointer(np.float32),  # probs
            np.ctypeslib.ndpointer(np.uint8),    # visited
            ctypes.c_int64, ctypes.c_int32,      # n_edges, n_threads
            np.ctypeslib.ndpointer(np.uint8),    # ealive (out)
            np.ctypeslib.ndpointer(np.float64),  # weight (out)
            np.ctypeslib.ndpointer(np.float64),  # bsum (out)
            np.ctypeslib.ndpointer(np.int64),    # blast (out)
            np.ctypeslib.ndpointer(np.int64),    # alive_count (out, [1])
        ]
        lib.gn_sampler_update.restype = None
        lib.gn_sampler_update.argtypes = [
            np.ctypeslib.ndpointer(np.int64),    # csr_ptr
            np.ctypeslib.ndpointer(np.int32),    # csr_col
            np.ctypeslib.ndpointer(np.int64),    # csr_eid
            np.ctypeslib.ndpointer(np.int64),    # csc_ptr
            np.ctypeslib.ndpointer(np.int32),    # csc_row
            np.ctypeslib.ndpointer(np.int64),    # csc_eid
            np.ctypeslib.ndpointer(np.int32),    # newly
            ctypes.c_int64, ctypes.c_int64,      # n_newly, n_edges
            np.ctypeslib.ndpointer(np.uint8),    # ealive (mutated)
            np.ctypeslib.ndpointer(np.float64),  # weight
            np.ctypeslib.ndpointer(np.float64),  # bsum (mutated)
            np.ctypeslib.ndpointer(np.int64),    # blast (mutated)
            np.ctypeslib.ndpointer(np.int64),    # alive_count (mutated, [1])
        ]
        lib.gn_sample_seed_edges_inc.restype = ctypes.c_int64
        lib.gn_sample_seed_edges_inc.argtypes = [
            np.ctypeslib.ndpointer(np.uint8),    # ealive
            np.ctypeslib.ndpointer(np.float64),  # weight
            np.ctypeslib.ndpointer(np.float64),  # bsum
            np.ctypeslib.ndpointer(np.int64),    # blast
            np.ctypeslib.ndpointer(np.int64),    # alive_count [1]
            ctypes.c_int64,                      # n_edges
            np.ctypeslib.ndpointer(np.float64),  # uniforms
            ctypes.c_int64,                      # k
            np.ctypeslib.ndpointer(np.int64),    # out seeds
        ]
        lib.gn_decode_chunk.restype = ctypes.c_int64
        lib.gn_decode_chunk.argtypes = [
            np.ctypeslib.ndpointer(np.int64),    # row_ptr
            np.ctypeslib.ndpointer(np.int32),    # col
            np.ctypeslib.ndpointer(np.int64),    # eid
            np.ctypeslib.ndpointer(np.int64),    # csc_ptr
            np.ctypeslib.ndpointer(np.int32),    # csc_row
            np.ctypeslib.ndpointer(np.int64),    # csc_eid
            np.ctypeslib.ndpointer(np.int32),    # src
            np.ctypeslib.ndpointer(np.int32),    # dst
            np.ctypeslib.ndpointer(np.float32),  # log_probs
            np.ctypeslib.ndpointer(np.int64),    # prefix_len
            np.ctypeslib.ndpointer(np.int64),    # read_len
            ctypes.c_int64, ctypes.c_int64,      # n_nodes, n_edges
            ctypes.c_int64,                      # n_paths
            ctypes.c_int32, ctypes.c_float,      # use_early_stop, threshold
            ctypes.c_int64, ctypes.c_int32,      # len_threshold, n_threads
            np.ctypeslib.ndpointer(np.float64),  # uniforms [max_contigs*k]
            ctypes.c_int64,                      # max_contigs
            np.ctypeslib.ndpointer(np.uint8),    # visited (mutated)
            np.ctypeslib.ndpointer(np.uint8),    # ealive (mutated)
            np.ctypeslib.ndpointer(np.float64),  # weight
            np.ctypeslib.ndpointer(np.float64),  # bsum (mutated)
            np.ctypeslib.ndpointer(np.int64),    # blast (mutated)
            np.ctypeslib.ndpointer(np.int64),    # alive_count (mutated)
            np.ctypeslib.ndpointer(np.int32),    # absorb_stamp (mutated)
            np.ctypeslib.ndpointer(np.int32),    # absorb_epoch [1] (mutated)
            np.ctypeslib.ndpointer(np.int32),    # round_stamp (mutated)
            np.ctypeslib.ndpointer(np.int32),    # round_wbuf (scratch)
            np.ctypeslib.ndpointer(np.int32),    # round_epoch [1] (mutated)
            np.ctypeslib.ndpointer(np.int32),    # newly scratch
            np.ctypeslib.ndpointer(np.int64),    # seeds scratch
            np.ctypeslib.ndpointer(np.int32),    # out_walks_flat
            np.ctypeslib.ndpointer(np.int64),    # out_walk_lens
            np.ctypeslib.ndpointer(np.int64),    # out_contig_lens
            np.ctypeslib.ndpointer(np.int32),    # out_status [1]
        ]
        lib.gn_gt_sweep.restype = ctypes.c_int64
        lib.gn_gt_sweep.argtypes = [
            np.ctypeslib.ndpointer(np.int64),    # fwd ptr
            np.ctypeslib.ndpointer(np.int32),    # fwd col
            np.ctypeslib.ndpointer(np.int64),    # rev ptr
            np.ctypeslib.ndpointer(np.int32),    # rev col
            np.ctypeslib.ndpointer(np.int64),    # key_sweep
            np.ctypeslib.ndpointer(np.int64),    # key_high
            ctypes.c_int64,                      # m
            np.ctypeslib.ndpointer(np.int32),    # comp_id (out)
        ]
        lib.gn_bfs_order.restype = None
        lib.gn_bfs_order.argtypes = [
            np.ctypeslib.ndpointer(np.int64),    # ptr
            np.ctypeslib.ndpointer(np.int32),    # col
            ctypes.c_int64,                      # m
            np.ctypeslib.ndpointer(np.int64),    # new_of_old (out)
        ]
        lib.gn_walk_edge_ids.restype = ctypes.c_int64
        lib.gn_walk_edge_ids.argtypes = [
            np.ctypeslib.ndpointer(np.int64),    # row_ptr
            np.ctypeslib.ndpointer(np.int32),    # col
            np.ctypeslib.ndpointer(np.int64),    # eid
            np.ctypeslib.ndpointer(np.int32),    # walk
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),    # out_eids
        ]
        _lib = lib
        return _lib


def have_native() -> bool:
    return get_lib() is not None
