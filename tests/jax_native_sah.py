"""A private build of the JAX package's native SAH builder for the port's
tests (imported by `tests/test_torch_*.py`; not a test module).

The JAX package's loader (`halogen_tpu/accel/native_loader.py`) compiles
`accel/native/bvh_builder.cpp` with `g++ -o` straight onto the library it
then loads, `accel/native/_bvh_builder.so`, whenever that file is older
than the source. Under pytest-xdist several workers can do so at once, and
a worker that loads the half-written file marks the builder unavailable
for the rest of its process: `build_bvh(method="sah")` then raises and
`method="auto"` quietly builds another BVH. The fixture below compiles the
same source with the loader's own flags into a private temporary file,
binds it with the loader's argument types and installs it as the loader's
library, so the JAX package's builds in these tests never read the shared
file. Nothing under `halogen_tpu/` is written.
"""

import ctypes
import os
import subprocess
import tempfile

import pytest

_LIB = None  # this process's private library, built once


def private_sah_library() -> ctypes.CDLL:
    """Compile (once per process) and bind the JAX package's SAH builder
    into a private temporary file; raises if g++ fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from halogen_tpu.accel import native_loader

    out_dir = tempfile.mkdtemp(prefix="halogen_sah_")
    path = os.path.join(out_dir, "_bvh_builder.so")
    # the JAX loader's flags (native_loader.py `_compile`)
    proc = subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", path,
         native_loader._SRC],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {native_loader._SRC}:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(path)
    fn = lib.halogen_build_bvh_sah
    fn.restype = ctypes.c_int32
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    fn.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                   f32p, f32p, i32p, i32p, i32p, ctypes.c_int32, i32p]
    _LIB = lib
    return lib


@pytest.fixture(scope="module", autouse=True)
def jax_native_sah():
    """Install the private library as the JAX loader's for the module."""
    from halogen_tpu.accel import native_loader

    lib = private_sah_library()
    with native_loader._lock:
        native_loader._lib = lib
        native_loader._load_failed = False
    yield lib
