"""Procedural test geometry (host copy of the generators of
``path_tracer_tpu/scene/procedural.py`` that the ported scenes use).

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


def _param_soup(f, nu: int, nv: int, eps_u: float = None, eps_v: float = None):
    """Triangle soup over a closed (u, v) parameter grid.

    ``f(u, v)`` maps arrays in [0, 1) to points [..., 3]. Both directions
    wrap. Smooth vertex normals come from central-difference partials —
    analytic enough for shading, independent of triangulation. Returns
    (positions [T, 3, 3], normals [T, 3, 3]) with T = 2 * nu * nv.
    """
    eps_u = eps_u if eps_u is not None else 0.25 / nu
    eps_v = eps_v if eps_v is not None else 0.25 / nv
    u = (np.arange(nu + 1, dtype=np.float64) / nu)[:, None]
    v = (np.arange(nv + 1, dtype=np.float64) / nv)[None, :]
    u = np.broadcast_to(u, (nu + 1, nv + 1))
    v = np.broadcast_to(v, (nu + 1, nv + 1))
    p = f(u, v)  # [nu+1, nv+1, 3]
    du = f(u + eps_u, v) - f(u - eps_u, v)
    dv = f(u, v + eps_v) - f(u, v - eps_v)
    n = np.cross(du, dv)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)

    # two triangles per cell, consistent winding
    p00, p10 = p[:-1, :-1], p[1:, :-1]
    p01, p11 = p[:-1, 1:], p[1:, 1:]
    n00, n10 = n[:-1, :-1], n[1:, :-1]
    n01, n11 = n[:-1, 1:], n[1:, 1:]
    t1p = np.stack([p00, p10, p11], axis=2)
    t2p = np.stack([p00, p11, p01], axis=2)
    t1n = np.stack([n00, n10, n11], axis=2)
    t2n = np.stack([n00, n11, n01], axis=2)
    positions = np.concatenate([t1p, t2p], axis=2).reshape(-1, 3, 3)
    normals = np.concatenate([t1n, t2n], axis=2).reshape(-1, 3, 3)
    # drop degenerate cells (zero-area triangles at parameterization pinches)
    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]
    area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
    keep = area2 > 1e-12 * float(np.abs(positions).max() or 1.0)
    return positions[keep].astype(np.float32), normals[keep].astype(np.float32)


def bumpy_sphere(center=(0.0, 0.0, 0.0), radius: float = 1.0,
                 nu: int = 192, nv: int = 192, bump: float = 0.12, seed: int = 7):
    """Harmonically displaced sphere — a non-convex "Stanford-bunny-class"
    stress mesh (2*nu*nv tris; 192x192 -> ~73K) whose lumpy surface defeats
    convex-shape shortcuts in traversal benchmarks."""
    rng = np.random.default_rng(seed)
    coef = rng.standard_normal((6, 5))

    def f(u, v):
        theta = u * 2.0 * np.pi          # longitude
        phi = v * np.pi                  # latitude [0, pi], wraps harmlessly
        sx = np.sin(phi) * np.cos(theta)
        sy = np.cos(phi)
        sz = np.sin(phi) * np.sin(theta)
        r = 1.0
        for k in range(coef.shape[0]):
            a, b, c, d, e = coef[k]
            r = r + (bump / (k + 1.5)) * np.sin(
                (k + 2) * theta * np.round(np.abs(a) + 1)
                + (k + 1) * phi * np.round(np.abs(b) + 1) + c
            ) * np.cos((k + 1) * phi + d)
        p = np.stack([sx, sy, sz], axis=-1) * (radius * r)[..., None]
        return p + np.asarray(center, np.float64)

    return _param_soup(f, nu, nv)


def knot(center=(0.0, 0.0, 0.0), scale: float = 1.0, tube: float = 0.35,
         nu: int = 1024, nv: int = 432, p: int = 2, q: int = 3,
         bump: float = 0.12, seed: int = 11):
    """Displaced (p, q) torus-knot tube — the "dragon-class" stress mesh
    (2*nu*nv tris; 1024x432 -> ~885K). Long, twisty, self-occluding geometry
    standing in for the reference's dragon.obj (main.rs:100-117); the
    harmonic displacement adds bunny/dragon-like surface detail."""
    rng = np.random.default_rng(seed)
    coef = rng.standard_normal((5, 3))

    def f(u, v):
        t = u * 2.0 * np.pi
        # (p, q) torus knot on a torus of radii (2, 1)
        r0 = np.cos(q * t) + 2.0
        cx = r0 * np.cos(p * t)
        cy = r0 * np.sin(p * t)
        cz = -np.sin(q * t)
        c = np.stack([cx, cy, cz], axis=-1)
        # finite-difference tangent frame
        dt = 1e-4
        t2 = t + dt
        r2 = np.cos(q * t2) + 2.0
        c2 = np.stack([r2 * np.cos(p * t2), r2 * np.sin(p * t2), -np.sin(q * t2)], axis=-1)
        tang = c2 - c
        tang /= np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True), 1e-20)
        up = np.zeros_like(c)
        up[..., 2] = 1.0
        side = np.cross(tang, up)
        side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True), 1e-20)
        norm = np.cross(side, tang)
        phi = v * 2.0 * np.pi
        r_tube = tube * np.ones_like(t)
        for k in range(coef.shape[0]):
            a, b, cc = coef[k]
            r_tube = r_tube + tube * (bump / (k + 1.2)) * np.sin(
                (k + 1) * phi + np.round(np.abs(a) * 3 + 1) * t + cc
            )
        off = side * (np.cos(phi) * r_tube)[..., None] + norm * (np.sin(phi) * r_tube)[..., None]
        return (c + off) * scale + np.asarray(center, np.float64)

    return _param_soup(f, nu, nv)
