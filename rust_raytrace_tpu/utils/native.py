"""ctypes loader for the native C++ scene pipeline (native/scene_pipeline.cc).

The reference's host-side scene stage is native (Rust geometry/octree, C++
marshalling); this module provides this build's equivalent: a shared
library compiled on demand with g++ and bound through ctypes (no pybind11 in
the image).  Every entry point has a numpy fallback — `available()` gates use,
and RUST_RAYTRACE_NO_NATIVE=1 disables it (tests exercise both paths).
"""

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "scene_pipeline.cc")


def _so_path() -> Optional[str]:
    """Shared-library path keyed by source CONTENT hash.

    The binary is never committed (a -march=native build from another machine
    could SIGILL or silently mismatch the numpy path); a source edit changes
    the hash, forcing a rebuild — mtimes are not trusted (git does not
    preserve them).
    """
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(os.path.dirname(_SRC), f"libscene-{h}.so")

F32P = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")


def _build(so: str) -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared",
             "-fPIC", _SRC, "-o", so],
            check=True, capture_output=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("RUST_RAYTRACE_NO_NATIVE"):
        return None
    so = _so_path()
    if so is None:
        return None
    if not os.path.exists(so) and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    lib.rt_make_triangles.argtypes = [F32P, ctypes.c_int64, F32P, F32P, F32P,
                                      F32P, F32P]
    lib.rt_morton_order.argtypes = [F32P, ctypes.c_int64, I64P]
    lib.rt_kd_order.argtypes = [F32P, ctypes.c_int64, ctypes.c_int64, I64P]
    lib.rt_build_octree.argtypes = [
        F32P, F32P, F32P, ctypes.c_int64, F32P, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.rt_build_octree.restype = ctypes.c_int32
    lib.rt_octree_fetch.argtypes = [F32P, F32P, I32P, I32P, I32P, I32P,
                                    I64P, I64P, I64P]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def make_triangles_native(points: np.ndarray):
    """C++ triangle precompute; returns (incenter, norm, sides, side_lens,
    bounding_r2) or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = pts.shape[0]
    incenter = np.empty((n, 3), np.float32)
    norm = np.empty((n, 3), np.float32)
    sides = np.empty((n, 3, 3), np.float32)
    side_lens = np.empty((n, 3), np.float32)
    r2 = np.empty(n, np.float32)
    lib.rt_make_triangles(pts.reshape(n, 9), n, incenter, norm,
                          sides.reshape(n, 9), side_lens, r2)
    return incenter, norm, sides, side_lens, r2


def morton_order_native(incenter: np.ndarray):
    lib = _load()
    if lib is None:
        return None
    inc = np.ascontiguousarray(incenter, dtype=np.float32)
    n = inc.shape[0]
    out = np.empty(max(n - 1, 0), np.int64)
    lib.rt_morton_order(inc, n, out)
    return out


def kd_order_native(incenter: np.ndarray, page_size: int):
    """C++ KD page ordering (behavioral copy of pages.kd_order) or None."""
    lib = _load()
    if lib is None:
        return None
    inc = np.ascontiguousarray(incenter, dtype=np.float32)
    n = inc.shape[0]
    out = np.empty(max(n - 1, 0), np.int64)
    lib.rt_kd_order(inc, n, int(page_size), out)
    return out


def build_octree_native(tris, orig, len2: float, maxdepth: int, minobjs: int):
    """C++ octree build; returns the flat node arrays or None.

    Output dict: node_orig [m,3], node_len2 [m], node_depth [m],
    children_start [m], num_children [m], child_indices [e],
    leaf_start [m], leaf_count [m], leaf_tris [k], root (int).
    """
    lib = _load()
    if lib is None:
        return None
    inc = np.ascontiguousarray(tris.incenter, dtype=np.float32)
    nrm = np.ascontiguousarray(tris.norm, dtype=np.float32)
    cor = np.ascontiguousarray(tris.corners, dtype=np.float32)
    n = inc.shape[0]
    o = np.ascontiguousarray(np.asarray(orig, dtype=np.float32))
    nn = ctypes.c_int64()
    nl = ctypes.c_int64()
    ne = ctypes.c_int64()
    root = lib.rt_build_octree(inc, nrm, cor.reshape(n, 9), n, o,
                               ctypes.c_float(len2), maxdepth, minobjs,
                               ctypes.byref(nn), ctypes.byref(nl),
                               ctypes.byref(ne))
    m, k, e = nn.value, nl.value, ne.value
    out = {
        "root": int(root),
        "node_orig": np.empty((m, 3), np.float32),
        "node_len2": np.empty(m, np.float32),
        "node_depth": np.empty(m, np.int32),
        "children_start": np.empty(m, np.int32),
        "num_children": np.empty(m, np.int32),
        "child_indices": np.empty(max(e, 1), np.int32),
        "leaf_start": np.empty(m, np.int64),
        "leaf_count": np.empty(m, np.int64),
        "leaf_tris": np.empty(max(k, 1), np.int64),
    }
    lib.rt_octree_fetch(out["node_orig"].reshape(m * 3), out["node_len2"],
                        out["node_depth"], out["children_start"],
                        out["num_children"], out["child_indices"],
                        out["leaf_start"], out["leaf_count"],
                        out["leaf_tris"])
    out["child_indices"] = out["child_indices"][:e]
    out["leaf_tris"] = out["leaf_tris"][:k]
    return out
