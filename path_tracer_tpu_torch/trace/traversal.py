"""Closest-hit and any-hit queries (port of the engine dispatch in
``path_tracer_tpu/trace/traversal.py:274-411``).

A geometry table (see `scene.scene.Scene.device`) is the scene's
``twolevel`` dict, whose ``iwalk`` entry holds a two-level engine (vwalk or
iwalk, `trace.iwalk`), or a triangle table carrying ``walk`` tables (world
soups above 16,384 triangles), ``stream`` ones (the streamed dense engine,
`trace.dense_stream`: above the walk's limit, or on request), ``bvh`` ones
(the stack BVH, `trace.bvh_stack`: world soups above 2,000,000 triangles
and light tables above 16,384) or ``dense`` ones (everything else, lights
included); both queries go to that engine. This is the one place the engine
is chosen. `brute_force_closest` is the sequential O(T) oracle
for tests.
"""

from __future__ import annotations

import torch

from path_tracer_tpu_torch.core.constants import EPSILON
from path_tracer_tpu_torch.trace import bvh_stack
from path_tracer_tpu_torch.trace.bvh_stack import _tri_intersect
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
    if "bvh" in tri:
        best, t, u, v = bvh_stack.closest_hit(tri["bvh"], origin, direction, t_limit)
        return best, t, u, v, *bvh_stack.shade(tri["normals_flat"], tri["model_rows"], best, u, v)
    return dense_closest_hit_shade(tri["dense"], origin, direction, t_limit)


def closest_hit(tri: dict, origin, direction, t_limit):
    """Closest intersection of each ray with ``tri``'s geometry. Returns
    ``(tri_idx, t, u, v)``; ``tri_idx == -1`` is a miss (t is the limit)."""
    if "bvh" in tri:  # a light table carries no shading rows
        return bvh_stack.closest_hit(tri["bvh"], origin, direction, t_limit)
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
    if "bvh" in tri:
        return bvh_stack.any_hit(tri["bvh"], origin, direction, t_limit)
    return dense_any_hit(tri["dense"], origin, direction, t_limit)


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
