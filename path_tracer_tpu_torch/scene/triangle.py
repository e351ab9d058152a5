"""Havel-Herout triangle precomputation (host, vectorized NumPy; a copy of
``path_tracer_tpu/scene/triangle.py``).

Port of ``Triangle::new`` (``src/tlas/tlas_bvh/blas/primitive.rs:31-54``):
per triangle we precompute the plane vector ``n0`` (geometric normal scaled by
2*area) with plane offset ``d0``, plus the two barycentric plane vectors
``n1/d1`` and ``n2/d2`` used by the "Yet Faster Ray-Triangle Intersection"
(Havel & Herout 2010) test. The device traversal kernels consume these arrays
directly; nothing is recomputed per ray.
"""

from __future__ import annotations

import numpy as np


def precompute(positions: np.ndarray) -> dict[str, np.ndarray]:
    """``positions``: ``[T, 3(vertex), 3(xyz)]`` -> dict of Havel-Herout arrays.

    Keys: ``n0, d0, n1, d1, n2, d2`` (``[T,3]``/``[T]``), and ``area`` ``[T]``
    (``primitive.rs:94``: 0.5 * |n0|).
    """
    a = positions[:, 0]
    ab = positions[:, 1] - a
    ac = positions[:, 2] - a

    n0 = np.cross(ab, ac)
    d0 = np.sum(n0 * a, axis=-1)
    scale = np.sum(n0 * n0, axis=-1)
    # Degenerate triangles (zero area) would divide by zero; keep them finite,
    # they can never be hit (det==0 for every ray).
    safe = np.where(scale > 0, scale, 1.0)[:, None]

    n1 = np.cross(ac, n0) / safe
    d1 = -np.sum(n1 * a, axis=-1)
    n2 = np.cross(n0, ab) / safe
    d2 = -np.sum(n2 * a, axis=-1)

    return {
        "n0": n0.astype(np.float32, copy=False),
        "d0": d0.astype(np.float32, copy=False),
        "n1": n1.astype(np.float32, copy=False),
        "d1": d1.astype(np.float32, copy=False),
        "n2": n2.astype(np.float32, copy=False),
        "d2": d2.astype(np.float32, copy=False),
        "area": (0.5 * np.sqrt(np.sum(n0 * n0, axis=-1))).astype(np.float32, copy=False),
    }


def aabbs(positions: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-triangle AABBs (``primitive.rs:97-103``). Returns (min, max) ``[T,3]``."""
    return positions.min(axis=1).astype(np.float32), positions.max(axis=1).astype(np.float32)


def transform(positions: np.ndarray, normals: np.ndarray, matrix: np.ndarray):
    """Apply a ``[3,4]`` rigid transform to triangle soup (instance baking).

    The reference asserts instance matrices are scale-free (``model.rs:43``),
    so normals transform with the rotation part directly.
    """
    # f32 throughout: instance matrices arrive as float64 python-built
    # arrays, and f32 @ f64 promotes the whole 8M-vertex matmul to f64
    # (measured ~10 s of the dragon bake) — the reference's glam math is
    # f32 anyway (model.rs:43 transforms in f32)
    rot = np.asarray(matrix[:, :3], np.float32)
    tr = np.asarray(matrix[:, 3], np.float32)
    pos32 = positions.astype(np.float32, copy=False)
    nrm32 = normals.astype(np.float32, copy=False)
    return pos32 @ rot.T + tr, nrm32 @ rot.T
