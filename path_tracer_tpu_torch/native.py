"""ctypes binding of the port's host builder (``csrc/pt_native.cpp``): OBJ
parsing, the binned-SAH BVH build and the walk engine's chunk partition.

The library is host C++ with a plain C interface, compiled at first use
with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into ``_build/`` beside
this package (tagged by the source and the flags, written to a temporary
file and moved into place, so concurrent processes may build it at once).
Without g++ (or if the build fails) `available` is False and the callers
(`scene.model`, `scene.bvh.chunk_partition`, `scene.scene`) run the NumPy
builders, which give the same output contract.

A port of the JAX package's ``native.py``: each function's output equals
its NumPy twin's; the SAH build and the chunk partition equal the JAX
package's native library bit for bit (``tests/test_torch_native.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "pt_native.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def lib_path() -> Path:
    """The library's path, tagged by its source and the flags."""
    tag = hashlib.sha1(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libpt_native_{tag}.so"


def build() -> Path | None:
    """Compile the library if it is not built yet; its path, or None
    without g++ or when the build fails."""
    lib = lib_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.pt_free.argtypes = [ctypes.c_void_p]
        lib.obj_load.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(_F32P), ctypes.POINTER(_F32P),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.obj_load.restype = ctypes.c_int
        lib.bvh_build.argtypes = [
            _F32P, _F32P, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(_I64P),
            *[ctypes.POINTER(_F32P)] * 4, *[ctypes.POINTER(_I32P)] * 4,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.bvh_build.restype = ctypes.c_int64
        lib.chunk_build.argtypes = [
            _F32P, _F32P, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(_I64P), ctypes.POINTER(_I64P), ctypes.POINTER(_I64P),
        ]
        lib.chunk_build.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (g++ is there)."""
    return _load() is not None


def _take(lib, ptr, count, np_dtype, shape):
    """Copy a malloc'd C array into NumPy and free it."""
    ctype = {np.float32: ctypes.c_float, np.int32: ctypes.c_int32, np.int64: ctypes.c_int64}[np_dtype]
    arr = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,)).copy()
    lib.pt_free(ptr)
    return arr.reshape(shape)


def load_obj(path) -> tuple[np.ndarray, np.ndarray]:
    """Native OBJ parse; the output of `scene.objio.load_obj`."""
    lib = _load()
    assert lib is not None
    pos_p, nrm_p = _F32P(), _F32P()
    n_tris = ctypes.c_int64()
    rc = lib.obj_load(str(path).encode(), ctypes.byref(pos_p), ctypes.byref(nrm_p), ctypes.byref(n_tris))
    if rc != 0:
        raise FileNotFoundError(path)
    t = n_tris.value
    return (_take(lib, pos_p, t * 9, np.float32, (t, 3, 3)),
            _take(lib, nrm_p, t * 9, np.float32, (t, 3, 3)))


def build_bvh(aabb_min: np.ndarray, aabb_max: np.ndarray, max_leaf: int = 4):
    """Native SAH build: ``(flat, perm, depth)``, the output of
    `scene.bvh.build_bvh`."""
    from path_tracer_tpu_torch.scene.bvh import NO_CHILD_BOUND

    lib = _load()
    assert lib is not None
    n = aabb_min.shape[0]
    bbmin = np.ascontiguousarray(aabb_min, np.float32)
    bbmax = np.ascontiguousarray(aabb_max, np.float32)
    perm_p = _I64P()
    f = [_F32P() for _ in range(4)]
    i = [_I32P() for _ in range(4)]
    depth = ctypes.c_int64()
    m = lib.bvh_build(
        bbmin.ctypes.data_as(_F32P), bbmax.ctypes.data_as(_F32P), n, max_leaf,
        ctypes.byref(perm_p), *[ctypes.byref(p) for p in f], *[ctypes.byref(p) for p in i],
        ctypes.byref(depth),
    )
    if m < 0:
        raise ValueError("bvh_build failed")
    perm = _take(lib, perm_p, n, np.int64, (n,))
    flat = {k: _take(lib, p, m * 3, np.float32, (m, 3))
            for k, p in zip(("c0_min", "c0_max", "c1_min", "c1_max"), f)}
    flat.update({k: _take(lib, p, m, np.int32, (m,))
                 for k, p in zip(("c0_idx", "c0_count", "c1_idx", "c1_count"), i)})
    no_c1 = flat["c1_count"][0] == -1
    flat["root_min"] = np.minimum(
        flat["c0_min"][0], np.where(no_c1, NO_CHILD_BOUND, flat["c1_min"][0])).astype(np.float32)
    flat["root_max"] = np.maximum(
        flat["c0_max"][0], np.where(no_c1, -NO_CHILD_BOUND, flat["c1_max"][0])).astype(np.float32)
    return flat, perm, int(depth.value)


def chunk_partition(aabb_min: np.ndarray, aabb_max: np.ndarray, chunk: int):
    """Native spatial chunk partition: ``(perm, starts, spans)``, the output
    of `scene.bvh.chunk_partition_py`, bit for bit."""
    lib = _load()
    assert lib is not None
    n = aabb_min.shape[0]
    bbmin = np.ascontiguousarray(aabb_min, np.float32)
    bbmax = np.ascontiguousarray(aabb_max, np.float32)
    perm_p, starts_p, spans_p = _I64P(), _I64P(), _I64P()
    k = lib.chunk_build(
        bbmin.ctypes.data_as(_F32P), bbmax.ctypes.data_as(_F32P), n, chunk,
        ctypes.byref(perm_p), ctypes.byref(starts_p), ctypes.byref(spans_p),
    )
    if k < 0:
        raise ValueError("chunk_build failed")
    return (_take(lib, perm_p, n, np.int64, (n,)), _take(lib, starts_p, k, np.int64, (k,)),
            _take(lib, spans_p, k, np.int64, (k,)))
