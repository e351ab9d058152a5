"""Wavefront OBJ loading with the reference parser's exact semantics.

Host copy of ``path_tracer_tpu/scene/objio.py``, the port of ``load_obj``
(``src/tlas/tlas_bvh/blas.rs:44-131``):

* only ``v``, ``vn`` and ``f`` records are honored (``vt`` ignored — the
  reference has a TODO at ``blas.rs:89``; comments/groups/materials skipped),
* 1-based indices with negative (relative) index support,
* polygon faces are fan-triangulated (``blas.rs:97-119``),
* missing vertex normals fall back to the (unnormalized) face normal
  (``blas.rs:107-116``),
* ``vn`` records are normalized on load (``blas.rs:74``).

Output is SoA NumPy: positions ``[T, 3, 3]`` and normals ``[T, 3, 3]`` per
triangle-vertex — the host-side staging format consumed by the BVH builder and
flattened onto the device. `scene.model.Model` parses through the native
builder (`path_tracer_tpu_torch.native.load_obj`, the same output) when it
is available.
"""

from __future__ import annotations

import numpy as np


def load_obj(path) -> tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file; returns ``(positions [T,3,3] f32, normals [T,3,3] f32)``."""
    positions: list = [np.zeros(3, np.float32)]  # 1-based indexing pad
    normals: list = [np.zeros(3, np.float32)]

    tri_pos: list = []
    tri_nrm: list = []

    with open(path, "r") as f:
        for line in f:
            tokens = line.split()
            if not tokens:
                continue
            kw = tokens[0]
            if kw == "v":
                positions.append(np.array(tokens[1:4], dtype=np.float32))
            elif kw == "vn":
                n = np.array(tokens[1:4], dtype=np.float32)
                norm = np.linalg.norm(n)
                normals.append(n / norm if norm > 0 else n)
            elif kw == "f":
                refs = []
                for token in tokens[1:]:
                    parts = token.split("/")
                    v = int(parts[0])
                    if v < 0:
                        v = len(positions) + v
                    vn = 0
                    if len(parts) >= 3 and parts[2] != "":
                        vn = int(parts[2])
                        if vn < 0:
                            vn = len(normals) + vn
                    refs.append((v, vn))
                # Fan triangulation (blas.rs:97-119)
                for i in range(1, len(refs) - 1):
                    corner = (refs[0], refs[i], refs[i + 1])
                    p = [positions[v] for v, _ in corner]
                    face_n = np.cross(p[1] - p[0], p[2] - p[0])
                    ns = [normals[vn] if vn != 0 else face_n for _, vn in corner]
                    tri_pos.append(np.stack(p))
                    tri_nrm.append(np.stack(ns))

    if not tri_pos:
        return np.zeros((0, 3, 3), np.float32), np.zeros((0, 3, 3), np.float32)
    return np.stack(tri_pos).astype(np.float32), np.stack(tri_nrm).astype(np.float32)


def save_obj(path, positions: np.ndarray, normals: np.ndarray | None = None) -> None:
    """Write a triangle soup ``[T,3,3]`` (+ optional per-vertex normals) as OBJ.

    Used to materialize procedural test scenes for the loader round-trip tests.
    """
    lines = []
    t = positions.shape[0]
    for tri in range(t):
        for v in range(3):
            p = positions[tri, v]
            lines.append(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}")
    if normals is not None:
        for tri in range(t):
            for v in range(3):
                n = normals[tri, v]
                lines.append(f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}")
        for tri in range(t):
            i = 3 * tri
            lines.append(f"f {i+1}//{i+1} {i+2}//{i+2} {i+3}//{i+3}")
    else:
        for tri in range(t):
            i = 3 * tri
            lines.append(f"f {i+1} {i+2} {i+3}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
