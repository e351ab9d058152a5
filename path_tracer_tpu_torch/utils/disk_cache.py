"""Host-side disk memoization for expensive pure scene generators (port of
``path_tracer_tpu/utils/disk_cache.py``).

Procedural meshes and environment maps are deterministic functions of their
arguments, but cost tens of seconds each at dragon/4K scale, and every
process would rebuild them. Their NumPy outputs are cached under
``.pt_host_cache/`` at the repo root, one ``.npy`` per array (a bare
``.npy`` loads in one read; arrays inside an ``.npz`` go through the zip
reader's small reads, far slower).

The key hashes the source of the whole file that defines the function
(its helpers in that file included) with its module, qualified name and
arguments, so editing a generator or a helper beside it invalidates its
entries; a helper in another module is not part of the key. An entry's
directory is named by the function's module and qualified name, so the
port's entries never collide with the JAX package's in the same
directory. ``PT_HOST_CACHE=0`` disables the cache; ``PT_HOST_CACHE=<dir>``
relocates it. Failures (a read-only file system, an entry another process
published first) fall back to a plain call, and a write that could not be
published is removed.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import shutil

import numpy as np

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".pt_host_cache",
)


def cache_dir() -> str | None:
    """The cache's directory, or None when ``PT_HOST_CACHE=0``."""
    v = os.environ.get("PT_HOST_CACHE", "1")
    if v == "0":
        return None
    return v if v not in ("", "1") else _DEFAULT_DIR


def entry_path(fn, *args, **kwargs) -> str | None:
    """The directory that holds (or would hold) ``fn(*args, **kwargs)``'s
    arrays, or None when the cache is off."""
    d = cache_dir()
    if d is None:
        return None
    with open(inspect.getsourcefile(fn), encoding="utf-8") as f:
        src = f.read()
    key = hashlib.sha1(
        repr((fn.__module__, fn.__qualname__, args, sorted(kwargs.items()), src)).encode()
    ).hexdigest()
    return os.path.join(d, f"{fn.__module__}.{fn.__qualname__}-{key[:16]}")


def cached_arrays(fn, *args, **kwargs):
    """Call ``fn(*args, **kwargs)`` through the disk cache.

    ``fn`` must be pure and return a NumPy array or a tuple of them; the
    arguments must repr() deterministically (numbers, strings)."""
    try:
        entry = entry_path(fn, *args, **kwargs)
        if entry is None:
            return fn(*args, **kwargs)
        if os.path.isdir(entry):
            names = sorted(os.listdir(entry), key=lambda f: int(f[1:-4]))
            out = tuple(np.load(os.path.join(entry, f)) for f in names)
            return out[0] if len(out) == 1 else out
    except Exception:
        return fn(*args, **kwargs)
    out = fn(*args, **kwargs)
    arrs = out if isinstance(out, tuple) else (out,)
    tmp = entry + f".tmp{os.getpid()}"
    try:
        os.makedirs(tmp, exist_ok=True)
        for i, a in enumerate(arrs):
            np.save(os.path.join(tmp, f"a{i}.npy"), np.asarray(a))
        os.replace(tmp, entry)  # atomic publish (same directory)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
    return out
