"""Native (C++) host-runtime components: SAH BVH builder + OBJ loader.

The reference keeps its host runtime in C++ (tinyobjloader + bvh.cpp); these
are fresh twins compiled to ``libradish_native.so`` and bound
through ctypes.  Everything degrades gracefully to the numpy implementations
when the library is missing or ``RADISH_NATIVE=0``.

Build: ``python -m radish_pt_tpu.native.build`` (or automatic on first use).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "libradish_native.so")
_SOURCES = [
    os.path.join(_HERE, "src", "bvh_builder.cpp"),
    os.path.join(_HERE, "src", "obj_loader.cpp"),
    os.path.join(_HERE, "src", "cluster_cuts.cpp"),
]

_lib = None
_tried = False


def _build_library() -> bool:
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC",
        "-std=c++17", "-o", _LIB_PATH, *_SOURCES,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:  # noqa: BLE001 - report, fall back to numpy
        print(f"[radish native] build failed ({e}); using numpy fallback",
              file=sys.stderr)
        return False


def load_library():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("RADISH_NATIVE", "1") == "0":
        return None
    if not os.path.exists(_LIB_PATH) or any(
        os.path.getmtime(s) > os.path.getmtime(_LIB_PATH) for s in _SOURCES
    ):
        if not _build_library():
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        print(f"[radish native] load failed ({e}); using numpy fallback",
              file=sys.stderr)
        return None

    import numpy as np  # noqa: F401 (ensures ctypes interplay is sane)

    lib.radish_build_bvh.restype = ctypes.c_int
    lib.radish_obj_parse.restype = ctypes.c_void_p
    lib.radish_obj_parse.argtypes = [ctypes.c_char_p]
    lib.radish_obj_num_corners.restype = ctypes.c_int64
    lib.radish_obj_num_corners.argtypes = [ctypes.c_void_p]
    lib.radish_obj_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.radish_obj_free.argtypes = [ctypes.c_void_p]
    lib.radish_cluster_cuts.restype = ctypes.c_int64
    lib.radish_cluster_cuts.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int64, ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


def native_build_bvh(vertices, leaf_size: int):
    """Native BVH build; returns the same tuple layout as accel.bvh or None."""
    import numpy as np

    lib = load_library()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, dtype=np.float32).reshape(-1, 3)
    num_prims = v.shape[0] // 3
    max_nodes = 2 * num_prims - 1 if num_prims > 1 else 1
    L = leaf_size

    bounds_min = np.empty((max_nodes, 3), np.float32)
    bounds_max = np.empty((max_nodes, 3), np.float32)
    # the C side writes the 6 direction planes contiguously with the ACTUAL
    # node count as stride, so keep these flat and reshape after the call
    node_leaf = np.empty((6 * max_nodes,), np.int32)
    node_aabb = np.empty((6 * max_nodes,), np.int32)
    node_miss = np.empty((6 * max_nodes,), np.int32)
    leaf_tris = np.empty((num_prims, L * 9), np.float32)
    leaf_map = np.empty((num_prims * L,), np.int32)
    out = np.zeros(3, np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.radish_build_bvh(
        ptr(v), ctypes.c_int(num_prims), ctypes.c_int(L),
        ptr(bounds_min), ptr(bounds_max), ptr(node_leaf), ptr(node_aabb),
        ptr(node_miss), ptr(leaf_tris), ptr(leaf_map),
        ptr(out[0:1]), ptr(out[1:2]), ptr(out[2:3]),
    )
    if rc != 0:
        return None
    size, n_leaves, depth = int(out[0]), int(out[1]), int(out[2])
    return (
        bounds_min[:size].copy(),
        bounds_max[:size].copy(),
        node_leaf[: 6 * size].reshape(6, size).copy(),
        node_aabb[: 6 * size].reshape(6, size).copy(),
        node_miss[: 6 * size].reshape(6, size).copy(),
        leaf_tris[:n_leaves].copy(),
        leaf_map[: n_leaves * L].copy(),
        depth,
    )


def native_load_obj(path: str):
    """Native OBJ parse; returns (v, n, uv) numpy arrays or None."""
    import numpy as np

    lib = load_library()
    if lib is None:
        return None
    h = lib.radish_obj_parse(path.encode())
    if not h:
        return None
    try:
        nc = lib.radish_obj_num_corners(h)
        v = np.empty((nc, 3), np.float32)
        n = np.empty((nc, 3), np.float32)
        uv = np.empty((nc, 2), np.float32)
        lib.radish_obj_copy(
            h,
            v.ctypes.data_as(ctypes.c_void_p),
            n.ctypes.data_as(ctypes.c_void_p),
            uv.ctypes.data_as(ctypes.c_void_p),
        )
        return v, n, uv
    finally:
        lib.radish_obj_free(h)


def native_cluster_cuts(pmin, pmax, sub: int, lam: float, chunk: int):
    """Area-optimal cluster segmentation (scene/build._cluster_cuts DP) in
    C++; returns int64 cut positions or None when the library is absent."""
    import numpy as np

    lib = load_library()
    if lib is None:
        return None
    pmin = np.ascontiguousarray(pmin, np.float32)
    pmax = np.ascontiguousarray(pmax, np.float32)
    T = pmin.shape[0]
    out = np.empty(T + 1, np.int64)
    n = lib.radish_cluster_cuts(
        pmin.ctypes.data, pmax.ctypes.data, T, sub, ctypes.c_float(lam),
        chunk, out.ctypes.data,
    )
    return out[:n].copy()
