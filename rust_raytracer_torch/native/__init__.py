"""Native (C++) scene-build core: binned-SAH BVH builder + OBJ loader.

The reference's host-side hot loops are native Rust (octree build,
octree.rs:21-210; OBJ parse, loaders/obj.rs).  Here they are C++
(bvh.cc / obj.cc), compiled on demand with g++ into a shared library and
called through ctypes — no pybind11 dependency.  If the toolchain is
unavailable, or RRT_NO_NATIVE is set when the library is first asked for,
the callers fall back to the NumPy implementations (scene/bvh_builder.py,
utils/assets.py), which are correct but slower and (for the BVH) lower
quality (Morton complete-tree vs binned SAH).

The port's copy of rust_raytracer_tpu/native/: the same sources and C
interface, built into build/rrt_torch/_rrt_native.so at the root of the
checkout (gitignored) rather than inside the package.  The library is
written to a temporary file and renamed into place, so processes that
build it at the same time never load a half-written file.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO_PATH = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "rrt_torch",
                        "_rrt_native.so")
_SOURCES = [os.path.join(_HERE, "bvh.cc"), os.path.join(_HERE, "obj.cc")]

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _build_library() -> bool:
    try:
        os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO_PATH))
        os.close(fd)
    except OSError:
        return False
    cmd = [
        "g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
        "-o", tmp, *_SOURCES,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        os.replace(tmp, _SO_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _load():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("RRT_NO_NATIVE"):
            _lib_failed = True
            return None
        stale = (
            not os.path.exists(_SO_PATH)
            or any(
                os.path.getmtime(s) > os.path.getmtime(_SO_PATH)
                for s in _SOURCES
            )
        )
        if stale and not _build_library():
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _lib_failed = True
            return None

        lib.rrt_bvh_build.restype = ctypes.c_void_p
        lib.rrt_bvh_build.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.rrt_bvh_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.rrt_bvh_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
        lib.rrt_bvh_free.argtypes = [ctypes.c_void_p]

        lib.rrt_obj_load.restype = ctypes.c_void_p
        lib.rrt_obj_load.argtypes = [ctypes.c_char_p]
        lib.rrt_obj_counts.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.rrt_obj_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.rrt_obj_free.argtypes = [ctypes.c_void_p]

        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int):
    """Binned-SAH threaded flat BVH.  Returns the same tuple layout as
    scene/bvh_builder.FlatBVH, or None if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = tri_min.shape[0]
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    h = lib.rrt_bvh_build(_ptr(tri_min), _ptr(tri_max),
                          ctypes.c_int64(n), ctypes.c_int32(leaf_size))
    if not h:
        return None
    try:
        n_nodes = ctypes.c_int64()
        n_slots = ctypes.c_int64()
        lib.rrt_bvh_counts(h, ctypes.byref(n_nodes), ctypes.byref(n_slots))
        m, s = n_nodes.value, n_slots.value
        node_min = np.empty((m, 3), np.float32)
        node_max = np.empty((m, 3), np.float32)
        hit_link = np.empty((m,), np.int32)
        miss_link = np.empty((m,), np.int32)
        leaf_start = np.empty((m,), np.int32)
        tri_order = np.empty((s,), np.int64)
        lib.rrt_bvh_copy(h, _ptr(node_min), _ptr(node_max), _ptr(hit_link),
                         _ptr(miss_link), _ptr(leaf_start), _ptr(tri_order))
    finally:
        lib.rrt_bvh_free(h)
    return node_min, node_max, hit_link, miss_link, leaf_start, tri_order


def parse_obj(path: str):
    """Parse an OBJ via the native loader.  Returns (verts, uvs, normals,
    tris) in utils/assets.parse_obj's layout, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.rrt_obj_load(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        nv = ctypes.c_int64()
        nn = ctypes.c_int64()
        nu = ctypes.c_int64()
        nt = ctypes.c_int64()
        lib.rrt_obj_counts(h, ctypes.byref(nv), ctypes.byref(nn),
                           ctypes.byref(nu), ctypes.byref(nt))
        verts = np.empty((nv.value, 3), np.float64)
        normals = np.empty((nn.value, 3), np.float64)
        uvs = np.empty((nu.value, 2), np.float64)
        tris = np.empty((nt.value, 3, 3), np.int32)
        lib.rrt_obj_copy(h, _ptr(verts), _ptr(normals), _ptr(uvs), _ptr(tris))
    finally:
        lib.rrt_obj_free(h)

    # post-parity with utils/assets.parse_obj (reference obj.rs:83-91):
    # a triangle "has uvs" only if all three corners do; missing normal
    # indices clamp to 0 (the reference unwraps them the same way).
    no_uv = (tris[:, :, 2] < 0).any(axis=1)
    tris[no_uv, :, 2] = -1
    tris[:, :, 1] = np.maximum(tris[:, :, 1], 0)
    norms = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.maximum(norms, 1e-30)
    return verts, uvs, normals, tris
