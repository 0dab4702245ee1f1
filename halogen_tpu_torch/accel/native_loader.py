"""ctypes loader for the native (C++) BVH builder (port of
`halogen_tpu/accel/native_loader.py`).

Compiles the port's own copy of the binned-SAH builder,
`accel/native/bvh_builder.cpp`, with `g++ -O3 -shared -fPIC` at first use
into the git-ignored `_build/` beside the package, keyed by the hash of
the source and the flags (as the CUDA libraries are), and exposes
`build_bvh_sah`. A failed build or load raises; there is no fallback.

The JAX package builds it with `-march=native`. The one ISA feature that
changes the builder's arrays is FMA: g++ contracts a * b + c into one
fused op where the target has it (`-ffp-contract=fast` is its default),
and the SAH costs and bin indices then round differently (4 of the
77,364 slots of the Testing Scene's active set move without it). So on
x86-64 the port asks for `-mfma` alone: the tree is then the same on
every host with FMA, and equal to the JAX package's `-march=native`
build there, without depending on the host's other extensions. Other
architectures (aarch64) always have FMA and contract by default.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "native", "bvh_builder.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC"] + (
    ["-mfma"] if platform.machine() in ("x86_64", "AMD64") else [])
_lock = threading.Lock()
_lib = None


def _library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"bvh_builder_{h.hexdigest()[:16]}.so")


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not os.path.exists(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                                      capture_output=True, text=True,
                                      timeout=300)
            except FileNotFoundError as e:
                os.unlink(tmp)
                raise RuntimeError("the native BVH builder needs g++") from e
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed on {_SRC}:\n{proc.stderr}")
            os.replace(tmp, path)  # atomic: no half-written library
        lib = ctypes.CDLL(path)
        fn = lib.halogen_build_bvh_sah
        fn.restype = ctypes.c_int32
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return lib


def build_bvh_sah(tri_verts: np.ndarray, max_leaf: int, max_depth: int):
    """Binned-SAH build of [T, 3, 3] triangles. Returns (lo, hi, index_a,
    count, tri_order, depth) in `accel/bvh.py`'s layout."""
    lib = _load()
    tris = np.ascontiguousarray(tri_verts, np.float32)
    n = tris.shape[0]
    cap = max(2 * n, 1)
    lo = np.zeros((cap, 3), np.float32)
    hi = np.zeros((cap, 3), np.float32)
    index_a = np.zeros((cap,), np.int32)
    count = np.zeros((cap,), np.int32)
    order = np.zeros((max(n, 1),), np.int32)
    depth = ctypes.c_int32(0)
    f32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    num = lib.halogen_build_bvh_sah(
        f32p(tris), n, max_leaf, max_depth,
        f32p(lo), f32p(hi), i32p(index_a), i32p(count), i32p(order), cap,
        ctypes.byref(depth),
    )
    if num < 0:
        raise RuntimeError(f"the native BVH builder failed ({num}) on "
                           f"{n} triangles")
    return (lo[:num].copy(), hi[:num].copy(), index_a[:num].copy(),
            count[:num].copy(), order, int(depth.value))
