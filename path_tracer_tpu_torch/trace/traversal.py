"""Closest-hit and any-hit queries (port of the engine dispatch in
``path_tracer_tpu/trace/traversal.py:274-411``).

A geometry table (see `scene.scene.Scene.device`) is the scene's
``twolevel`` dict, whose ``iwalk`` entry holds a two-level engine (vwalk or
iwalk, `trace.iwalk`), or a triangle table carrying ``walk`` tables (world
soups above 16,384 triangles), ``stream`` ones (the streamed dense engine,
`trace.dense_stream`: above the walk's limit, or on request) or ``dense``
ones (everything else, lights included); both queries go to that engine. This is the one place
the engine is chosen. `brute_force_closest` is the sequential O(T) oracle
for tests.
"""

from __future__ import annotations

import torch

from path_tracer_tpu_torch.core.constants import EPSILON
from path_tracer_tpu_torch.trace.dense_cuda import dense_any_hit, dense_closest_hit_shade
from path_tracer_tpu_torch.trace.dense_stream import dense_stream_any_hit, dense_stream_closest_hit_shade
from path_tracer_tpu_torch.trace.iwalk import iwalk_any_hit, iwalk_closest_hit_shade
from path_tracer_tpu_torch.trace.walk import walk_any_hit, walk_closest_hit_shade


def closest_hit_shade(tri: dict, origin, direction, t_limit):
    """Closest intersection plus the winner's shading fetch: ``(tri_idx, t,
    u, v, normal_raw [N,3], model)``; ``tri_idx == -1`` is a miss (t is the
    limit, u = v = 0). On a two-level engine the normal is already rotated
    to world space."""
    if "iwalk" in tri:
        return iwalk_closest_hit_shade(tri["iwalk"], origin, direction, t_limit)[:6]
    if "walk" in tri:
        return walk_closest_hit_shade(tri["walk"], origin, direction, t_limit)
    if "stream" in tri:
        return dense_stream_closest_hit_shade(tri["stream"], origin, direction, t_limit)
    return dense_closest_hit_shade(tri["dense"], origin, direction, t_limit)


def closest_hit(tri: dict, origin, direction, t_limit):
    """Closest intersection of each ray with ``tri``'s geometry. Returns
    ``(tri_idx, t, u, v)``; ``tri_idx == -1`` is a miss (t is the limit)."""
    best, t, u, v, _, _ = closest_hit_shade(tri, origin, direction, t_limit)
    return best, t, u, v


def any_hit(tri: dict, origin, direction, t_limit):
    """True where an intersection with EPSILON < t < t_limit exists (the
    shadow test, ``TLAS::any_intersect``)."""
    if "iwalk" in tri:
        return iwalk_any_hit(tri["iwalk"], origin, direction, t_limit)
    if "walk" in tri:
        return walk_any_hit(tri["walk"], origin, direction, t_limit)
    if "stream" in tri:
        return dense_stream_any_hit(tri["stream"], origin, direction, t_limit)
    return dense_any_hit(tri["dense"], origin, direction, t_limit)


def _same_sign(a, b):
    return (a >= 0.0) == (b >= 0.0)


def _tri_intersect(rows, o, d, t_min, t_max):
    """Havel-Herout test of each ray against its plane row ``rows [N, >=12]``
    (``traversal._tri_intersect`` order). Returns (hit, t, u, v)."""
    d0, d1, d2 = rows[:, 3], rows[:, 7], rows[:, 11]

    def dot3(ax, ay, az, b):
        return ax * b[:, 0] + ay * b[:, 1] + az * b[:, 2]

    det = dot3(rows[:, 0], rows[:, 1], rows[:, 2], d)
    td = d0 - dot3(rows[:, 0], rows[:, 1], rows[:, 2], o)
    c1 = _same_sign(td - det * t_min, det * t_max - td)
    px = det * o[:, 0] + td * d[:, 0]
    py = det * o[:, 1] + td * d[:, 1]
    pz = det * o[:, 2] + td * d[:, 2]
    ud = rows[:, 4] * px + rows[:, 5] * py + rows[:, 6] * pz + det * d1
    c2 = _same_sign(ud, det - ud)
    vd = rows[:, 8] * px + rows[:, 9] * py + rows[:, 10] * pz + det * d2
    c3 = _same_sign(vd, det - ud - vd)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    return c1 & c2 & c3 & (det != 0.0), td * inv_det, ud * inv_det, vd * inv_det


def brute_force_closest(planes: torch.Tensor, origin, direction, t_limit):
    """Sequential O(T) oracle: test every plane row ``[T, >=12]`` in order,
    shrinking the window on each hit. Returns ``(tri_idx, t, u, v)``."""
    n = origin.shape[0]
    best = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    bu = torch.zeros(n, dtype=origin.dtype, device=origin.device)
    bv = torch.zeros_like(bu)
    t_max = t_limit.clone()
    for i in range(planes.shape[0]):
        h, t, u, v = _tri_intersect(planes[i].expand(n, -1), origin, direction, EPSILON, t_max)
        t_max = torch.where(h, t, t_max)
        best = torch.where(h, i, best)
        bu = torch.where(h, u, bu)
        bv = torch.where(h, v, bv)
    return best, t_max, bu, bv
