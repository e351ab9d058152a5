"""Procedural test geometry (host copy of the generators of
``path_tracer_tpu/scene/procedural.py`` that the four ported scenes use).

The reference renders OBJ assets that are not part of its repository
(``models/cornell/*.obj``, ``src/main.rs:100-115``), so benchmark and test
scenes are generated here: a Cornell box matching the classic 555-unit layout
the reference scene files describe, plus icospheres for mesh/BVH stress tests.
All generators return triangle soup ``[T,3,3]`` (positions, normals).
"""

from __future__ import annotations

import numpy as np


def _quad(a, b, c, d) -> np.ndarray:
    """Two triangles for quad abcd (counter-clockwise winding)."""
    a, b, c, d = (np.asarray(p, np.float32) for p in (a, b, c, d))
    return np.stack([np.stack([a, b, c]), np.stack([a, c, d])])


def _soup(quads: list) -> tuple[np.ndarray, np.ndarray]:
    pos = np.concatenate(quads).astype(np.float32)
    fn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    fn = fn / np.linalg.norm(fn, axis=-1, keepdims=True)
    nrm = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
    return pos, nrm


# Classic Cornell dimensions, recentred so the box spans x,y in [-278, 278]-ish
# the way the reference camera (looking down -z from z=1000) expects.
_S = 555.0 / 2.0  # half-size


def cornell_walls():
    """Floor, ceiling, back wall (the reference's cb_main.obj equivalent)."""
    s, h = _S, 2 * _S
    return _soup([
        _quad([-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]),        # floor (y=0, +y normal)
        _quad([-s, h, s], [s, h, s], [s, h, -s], [-s, h, -s]),        # ceiling (-y normal)
        _quad([-s, 0, -s], [-s, h, -s], [s, h, -s], [s, 0, -s]),      # back wall (+z normal)
    ])


def cornell_left():
    """Left wall at x=-s (green in the reference scene)."""
    s, h = _S, 2 * _S
    return _soup([_quad([-s, 0, s], [-s, h, s], [-s, h, -s], [-s, 0, -s])])


def cornell_right():
    """Right wall at x=+s (red)."""
    s, h = _S, 2 * _S
    return _soup([_quad([s, 0, -s], [s, h, -s], [s, h, s], [s, 0, s])])


def cornell_light(size: float = 130.0/ 2, y_off: float = 1.0):
    """Area light just below the ceiling, facing down."""
    s = size
    y = 2 * _S - y_off
    return _soup([_quad([-s, y, s], [s, y, s], [s, y, -s], [-s, y, -s])])


def box(center, half_extents):
    """Axis-aligned box (outward normals)."""
    cx, cy, cz = center
    hx, hy, hz = half_extents
    lo = np.array([cx - hx, cy - hy, cz - hz])
    hi = np.array([cx + hx, cy + hy, cz + hz])
    return _soup([
        _quad([lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]], [hi[0], lo[1], lo[2]], [lo[0], lo[1], lo[2]]),  # bottom -y
        _quad([lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]], [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]]),  # top
        _quad([lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]], [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]),  # front +z
        _quad([hi[0], lo[1], lo[2]], [lo[0], lo[1], lo[2]], [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]]),  # back -z
        _quad([lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]], [lo[0], hi[1], hi[2]], [lo[0], hi[1], lo[2]]),  # left -x
        _quad([hi[0], lo[1], hi[2]], [hi[0], lo[1], lo[2]], [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]]),  # right +x
    ])


def icosphere(center=(0.0, 0.0, 0.0), radius: float = 1.0, subdivisions: int = 3):
    """Subdivided icosahedron with smooth (spherical) vertex normals.

    ~20*4^s triangles: s=3 -> 1280, s=5 -> 20480. Stress geometry standing in
    for the reference's dragon/bunny-class meshes.
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ])

    for _ in range(subdivisions):
        tri = verts[faces]  # [F,3,3]
        mid01 = tri[:, 0] + tri[:, 1]
        mid12 = tri[:, 1] + tri[:, 2]
        mid20 = tri[:, 2] + tri[:, 0]
        new_tris = []
        for f in range(len(faces)):
            v0, v1, v2 = tri[f]
            m01, m12, m20 = mid01[f], mid12[f], mid20[f]
            new_tris += [[v0, m01, m20], [v1, m12, m01], [v2, m20, m12], [m01, m12, m20]]
        pts = np.asarray(new_tris)
        pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
        # Re-index into verts/faces
        flat = pts.reshape(-1, 3)
        verts, inv = np.unique(np.round(flat, 9), axis=0, return_inverse=True)
        verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
        faces = inv.reshape(-1, 3)

    tri = verts[faces]
    center = np.asarray(center, np.float64)
    positions = (tri * radius + center).astype(np.float32)
    normals = tri.astype(np.float32)  # unit sphere points are their own normals
    return positions, normals
