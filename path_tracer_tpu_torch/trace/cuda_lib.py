"""Build and load the port's CUDA sources (``csrc/<name>.cu``, which may
include the shared headers ``csrc/*.cuh``).

Each source has a plain C interface and is compiled at first use with
``nvcc`` into ``_build/`` beside this package, as a shared library loaded
through ctypes. ``LAUNCHES`` counts kernel launches per kernel; each
wrapper adds one where it launches its kernel, so a run can show that its
queries went through the kernels.

Every source is compiled with ``-fmad=false`` and without
``--use_fast_math``: each product and sum is rounded on its own, in the
order written, which is the order of the plain torch versions (torch
evaluates each elementwise op separately), so kernel and plain version give
the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

LAUNCHES = {
    "closest": 0, "any": 0, "walk_closest": 0, "walk_any": 0,
    "vwalk_closest": 0, "vwalk_any": 0, "iwalk_closest": 0, "iwalk_any": 0,
    "stream_closest": 0, "stream_any": 0, "row_gather": 0, "tile_gather": 0,
}

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _lib_path(name: str, csrc: Path = CSRC) -> Path:
    """The library's path, tagged by its source, every header and the flags."""
    src = (csrc / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(*names: str, csrc: Path = CSRC) -> list[Path]:
    """Compile ``<csrc>/<name>.cu`` for each name (once per source and flags
    version; all missing ones by concurrent nvcc processes) and return the
    library paths; ``csrc`` is this package's sources unless another
    tree's are named. nvcc's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library with the suffix ``.log``. Raises
    with nvcc's output if a build fails."""
    libs = [_lib_path(n, csrc) for n in names]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, lib in zip(names, libs):
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((lib, tmp, proc))
    failed = []
    for lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{lib.name}: nvcc failed ({proc.returncode}):\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str, argtypes: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if needed), with
    ``argtypes`` set on its entry points; each returns an int error code."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build(name)[0]))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]
