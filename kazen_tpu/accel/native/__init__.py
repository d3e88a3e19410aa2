"""ctypes loader for the native binned-SAH BVH builder.

Compiles the committed bvh_builder.cpp on first use with g++ into
``build/libbvh-<source hash>.so`` beside it (``build/`` is gitignored), so
a changed source never loads a stale library. Without a compiler it
returns None and accel/bvh.py uses the numpy builder; ``reason`` says why.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")

_lib = None
_tried = False
reason = ""  # why the native builder is unavailable ("" when it loaded)


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_DIR, "build", f"libbvh-{digest}.so")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, reason
    if _tried:
        return _lib
    _tried = True
    try:
        path = _lib_path()
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.bvh_build.restype = ctypes.c_void_p
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.bvh_read.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_float)
        ] * 2 + [ctypes.POINTER(ctypes.c_int32)] * 4
        lib.bvh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        reason = f"{type(e).__name__}: {e}"
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def build(
    V: np.ndarray, F: np.ndarray, leaf_size: int
) -> Optional[Tuple[np.ndarray, ...]]:
    """Returns (bounds_min, bounds_max, skip, prim_offset, prim_count,
    prim_faces) or None when the native builder is unavailable."""
    lib = _load()
    if lib is None:
        return None
    V = np.ascontiguousarray(V, np.float32)
    F = np.ascontiguousarray(F, np.int32)
    nf = len(F)
    n_nodes = ctypes.c_int32(0)
    handle = lib.bvh_build(
        V.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(V),
        F.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nf,
        leaf_size,
        ctypes.byref(n_nodes),
    )
    m = n_nodes.value
    bounds_min = np.empty((m, 3), np.float32)
    bounds_max = np.empty((m, 3), np.float32)
    skip = np.empty(m, np.int32)
    prim_offset = np.empty(m, np.int32)
    prim_count = np.empty(m, np.int32)
    prim_faces = np.empty(nf, np.int32)
    lib.bvh_read(
        handle,
        bounds_min.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bounds_max.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        skip.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        prim_offset.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        prim_count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        prim_faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    lib.bvh_free(handle)
    return bounds_min, bounds_max, skip, prim_offset, prim_count, prim_faces
