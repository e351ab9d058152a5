"""Stack BVH engine: closest hit and any hit by a per-ray descent of the
flattened SAH tree, as torch ops. It takes what no kernel engine holds: a
light table above 16,384 triangles (the dense engine's limit) and a baked
world soup above 2,000,000 (the streamed engine's).

Port of ``path_tracer_tpu/trace/traversal.py`` (``pack_bvh``, ``pack_tris``,
``_child_codes_packed``, ``_closest_hit_impl``, ``_any_hit_impl``). The JAX
package writes this engine in plain XLA, not Pallas, so torch ops are its
port: no TPU kernel exists for it to replace. A kernel of its own waits until
a benchmark cell shows the path hot.

Design (the JAX one, written for a batch): every ray keeps its own stack of
pending nodes in an ``[N, STACK_DEPTH]`` tensor; each step pops or descends
one node per live lane, and the loop runs until no lane is live. Each step
works on the live lanes only (a lane's state never depends on another's).
Per step and lane:

* pop (the closest hit drops a popped entry whose entry t is past the
  current best, ``blas.rs:220-225``);
* an internal node: slab-test both children (``boundingbox.rs:115-131``,
  EPSILON entry clamp), descend into the nearer hit child, push the other
  (the any hit pushes child 1 unordered, ``blas.rs:257-294``);
* a leaf (encoded as ``-(start * (MAX_LEAF + 1) + count) - 2``): test its
  up to ``MAX_LEAF`` triangles with the Havel-Herout test on the ray moved
  to the leaf's entry t (``primitive.rs:147-155``); the closest hit takes a
  strictly nearer t, so the first tested triangle wins a tie.

The expressions and their order are the JAX package's; XLA may fuse a
product and a sum where torch rounds each, so a ray through a shared edge
can resolve to the other triangle.
"""

from __future__ import annotations

import numpy as np
import torch

from path_tracer_tpu_torch.core.constants import EPSILON

# the builder's leaf cap (the scene builds with max_leaf=MAX_LEAF)
MAX_LEAF = 4
STACK_DEPTH = 48
_POP = -1


# --- host packing (NumPy) ---


def pack_bvh(flat: dict) -> np.ndarray:
    """The 8 flat node arrays as one ``[M, 16]`` f32 row table: c0_min(3)
    c0_max(3) c1_min(3) c1_max(3) c0_idx c0_count c1_idx c1_count, the
    integers stored as exact float values (< 2^24)."""
    f = lambda k: np.asarray(flat[k], np.float32)  # noqa: E731

    def i(k):
        v = np.asarray(flat[k], np.int64)
        if np.abs(v).max(initial=0) >= (1 << 24):
            raise ValueError(f"{k} exceeds the float32 exact range")
        return v.astype(np.float32)[:, None]

    rows = np.concatenate(
        [f("c0_min"), f("c0_max"), f("c1_min"), f("c1_max"),
         i("c0_idx"), i("c0_count"), i("c1_idx"), i("c1_count")],
        axis=1,
    )
    return rows.astype(np.float32)


def pack_tris(tri: dict) -> np.ndarray:
    """Havel-Herout plane data as one ``[T, 16]`` f32 row table:
    n0(3) d0 n1(3) d1 n2(3) d2 + 4 zero lanes."""
    t = np.asarray(tri["d0"]).shape[0]
    return np.concatenate(
        [
            np.asarray(tri["n0"], np.float32), np.asarray(tri["d0"], np.float32)[:, None],
            np.asarray(tri["n1"], np.float32), np.asarray(tri["d1"], np.float32)[:, None],
            np.asarray(tri["n2"], np.float32), np.asarray(tri["d2"], np.float32)[:, None],
            np.zeros((t, 4), np.float32),
        ],
        axis=1,
    )


def pack(flat: dict, depth: int, tri: dict) -> dict:
    """The engine's tables: ``nodes`` [M, 16] (`pack_bvh`) and ``tris``
    [T, 16] (`pack_tris`) for the tree ``flat`` (`scene.bvh.flatten`) of
    depth ``depth`` over the plane table ``tri``. Raises if the tree is
    deeper than the traversal stack (the JAX scene's check)."""
    if depth > STACK_DEPTH:
        raise ValueError(f"BVH depth {depth} exceeds traversal STACK_DEPTH {STACK_DEPTH}")
    return {"nodes": pack_bvh(flat), "tris": pack_tris(tri)}


# --- the traversal (torch ops) ---


def _encode_leaf(idx, count):
    return -(idx * (MAX_LEAF + 1) + count) - 2


def _decode_leaf(code):
    v = -(code + 2)
    return v // (MAX_LEAF + 1), v % (MAX_LEAF + 1)


def _slab(bb_min, bb_max, o, inv_d, t_max):
    """Slab test of boxes ``[m, 3]`` (``boundingbox.rs:115-131``). Returns
    (hit, t_enter)."""
    t0 = (bb_min - o) * inv_d
    t1 = (bb_max - o) * inv_d
    tmax_v = t_max[:, None]
    eps = torch.tensor(EPSILON, dtype=t0.dtype, device=t0.device)
    t_small = torch.minimum(torch.maximum(t0, eps), torch.maximum(t1, eps))
    t_big = torch.maximum(torch.minimum(t0, tmax_v), torch.minimum(t1, tmax_v))
    t_enter = t_small.amax(dim=1)
    return t_enter <= t_big.amin(dim=1), t_enter


def _same_sign(a, b):
    return (a >= 0.0) == (b >= 0.0)


def _tri_terms(rows, o, d, t_min):
    """The Havel-Herout terms of each ray against its plane row (``rows
    [..., >=12]``, ``o``/``d`` [..., 3], ``traversal._tri_intersect``
    order) that do not depend on the window's end: (det, td, td - det *
    t_min, whether the barycentric sign tests pass and det != 0, t, u, v)."""
    d0, d1, d2 = rows[..., 3], rows[..., 7], rows[..., 11]

    def dot3(ax, ay, az, b):
        return ax * b[..., 0] + ay * b[..., 1] + az * b[..., 2]

    det = dot3(rows[..., 0], rows[..., 1], rows[..., 2], d)
    td = d0 - dot3(rows[..., 0], rows[..., 1], rows[..., 2], o)
    lo = td - det * t_min
    px = det * o[..., 0] + td * d[..., 0]
    py = det * o[..., 1] + td * d[..., 1]
    pz = det * o[..., 2] + td * d[..., 2]
    ud = rows[..., 4] * px + rows[..., 5] * py + rows[..., 6] * pz + det * d1
    c2 = _same_sign(ud, det - ud)
    vd = rows[..., 8] * px + rows[..., 9] * py + rows[..., 10] * pz + det * d2
    c3 = _same_sign(vd, det - ud - vd)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    return det, td, lo, c2 & c3 & (det != 0.0), td * inv_det, ud * inv_det, vd * inv_det


def _tri_intersect(rows, o, d, t_min, t_max):
    """Havel-Herout test of each ray against its plane row ``rows [N, >=12]``
    (``traversal._tri_intersect`` order). Returns (hit, t, u, v)."""
    det, td, lo, ok, t, u, v = _tri_terms(rows, o, d, t_min)
    return _same_sign(lo, det * t_max - td) & ok, t, u, v


def _leaf_terms(tris, start, count, is_leaf, o, d, t_est):
    """`_tri_terms` of the up-to-``MAX_LEAF`` triangles of each lane's leaf
    at once (``[m, MAX_LEAF]``), on the rays moved to the leaf's entry t
    (``primitive.rs:147-155``), plus which slots the lane tests."""
    k = torch.arange(MAX_LEAF, device=start.device)
    tri_idx = torch.clamp(start[:, None] + k, 0, tris.shape[0] - 1)
    rows = tris.index_select(0, tri_idx.reshape(-1)).view(-1, MAX_LEAF, tris.shape[1])
    o_moved = (o + d * t_est[:, None])[:, None, :]
    terms = _tri_terms(rows, o_moved, d[:, None, :], (EPSILON - t_est)[:, None])
    return terms, tri_idx, is_leaf[:, None] & (k < count[:, None])


def _children(nodes, ni):
    """Both children of internal nodes ``ni``: per child (box min, box max,
    code: node index or encoded leaf, exists)."""
    rows = nodes.index_select(0, ni)
    ints = rows[:, 12:16].to(torch.int64)  # stored as exact float values
    out = []
    for c in range(2):
        cidx, ccount = ints[:, 2 * c], ints[:, 2 * c + 1]
        code = torch.where(ccount > 0, _encode_leaf(cidx, ccount), cidx)
        out.append((rows[:, 6 * c : 6 * c + 3], rows[:, 6 * c + 3 : 6 * c + 6], code, ccount != -1))
    return out


class _Stacks:
    """Per-lane stacks of (node code, entry t), ``[N, STACK_DEPTH]``."""

    def __init__(self, n, device, dtype):
        self.node = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=device)
        self.t = torch.zeros((n, STACK_DEPTH), dtype=dtype, device=device)

    def read(self, rows, sp):
        """The entries at ``sp`` of lanes ``rows`` (any value where ``sp`` is
        past the stack: the caller does not use it)."""
        at = sp.clamp(max=STACK_DEPTH - 1)
        return self.node[rows, at], self.t[rows, at]

    def write(self, rows, sp, push, code, t):
        """Push (code, t) at ``sp`` for the lanes of ``rows`` where ``push``."""
        w = push & (sp < STACK_DEPTH)
        self.node[rows[w], sp[w]] = code[w]
        self.t[rows[w], sp[w]] = t[w]


def closest_hit(eng: dict, origin, direction, t_limit):
    """Closest hit of each ray: ``(tri_idx i32, t, u, v)``; -1 on a miss
    (t = t_limit, u = v = 0). ``eng`` holds `pack`'s ``nodes`` and ``tris``."""
    nodes, tris = eng["nodes"], eng["tris"]
    n, dev, dt = origin.shape[0], origin.device, origin.dtype
    inv_d = 1.0 / direction
    cur = torch.zeros(n, dtype=torch.int64, device=dev)  # the root, internal node 0
    cur_t = torch.zeros(n, dtype=dt, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stacks = _Stacks(n, dev, dt)
    t_max = t_limit.clone()
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, dtype=dt, device=dev)
    best_v = torch.zeros(n, dtype=dt, device=dev)
    act = torch.arange(n, device=dev)
    while act.numel():
        c, ct, s, tm = cur[act], cur_t[act], sp[act], t_max[act]
        o, d, inv = origin[act], direction[act], inv_d[act]
        # pop for lanes needing it, discarding stale entries at once
        do_pop = (c == _POP) & (s > 0)
        s = torch.where(do_pop, s - 1, s)
        popped, popped_t = stacks.read(act, s)
        fresh = do_pop & (popped_t <= tm)
        c = torch.where(fresh, popped, c)
        ct = torch.where(fresh, popped_t, ct)
        is_internal, is_leaf = c >= 0, c <= -2
        # internal step: test both children, descend near, push far
        (c0min, c0max, code0, ok0), (c1min, c1max, code1, ok1) = _children(
            nodes, torch.where(is_internal, c, 0))
        hit0, t0 = _slab(c0min, c0max, o, inv, tm)
        hit1, t1 = _slab(c1min, c1max, o, inv, tm)
        hit0, hit1 = hit0 & ok0, hit1 & ok1
        near_first = t0 <= t1
        both = hit0 & hit1
        stacks.write(act, s, is_internal & both, torch.where(near_first, code1, code0),
                     torch.where(near_first, t1, t0))
        s = torch.where(is_internal & both, s + 1, s)
        next_code = torch.where(both, torch.where(near_first, code0, code1),
                                torch.where(hit0, code0, torch.where(hit1, code1, _POP)))
        next_t = torch.where(both, torch.where(near_first, t0, t1),
                             torch.where(hit0, t0, torch.where(hit1, t1, 0.0)))
        # leaf step, the window shrinking after each triangle in order
        bi, bu, bv = best[act], best_u[act], best_v[act]
        start, count = _decode_leaf(torch.where(is_leaf, c, -2))
        (det, td, lo, ok, t, u, v), tri_idx, on = _leaf_terms(tris, start, count, is_leaf,
                                                              o, d, ct)
        for k in range(MAX_LEAF):
            upd = on[:, k] & ok[:, k] & _same_sign(lo[:, k], det[:, k] * (tm - ct) - td[:, k])
            tm = torch.where(upd, t[:, k] + ct, tm)
            bi = torch.where(upd, tri_idx[:, k], bi)
            bu = torch.where(upd, u[:, k], bu)
            bv = torch.where(upd, v[:, k], bv)
        cur[act] = torch.where(is_internal, next_code, _POP)
        cur_t[act] = torch.where(is_internal, next_t, ct)
        sp[act], t_max[act] = s, tm
        best[act], best_u[act], best_v[act] = bi, bu, bv
        act = act[(cur[act] != _POP) | (sp[act] > 0)]
    return best.to(torch.int32), t_max, best_u, best_v


def any_hit(eng: dict, origin, direction, t_limit):
    """True where a hit with EPSILON < t < t_limit exists (the shadow test)."""
    nodes, tris = eng["nodes"], eng["tris"]
    n, dev, dt = origin.shape[0], origin.device, origin.dtype
    inv_d = 1.0 / direction
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    cur_t = torch.zeros(n, dtype=dt, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stacks = _Stacks(n, dev, dt)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    act = torch.arange(n, device=dev)
    while act.numel():
        c, ct, s, tl = cur[act], cur_t[act], sp[act], t_limit[act]
        o, d, inv = origin[act], direction[act], inv_d[act]
        do_pop = (c == _POP) & (s > 0)
        s = torch.where(do_pop, s - 1, s)
        popped, popped_t = stacks.read(act, s)
        c = torch.where(do_pop, popped, c)
        ct = torch.where(do_pop, popped_t, ct)
        is_internal, is_leaf = c >= 0, c <= -2
        (c0min, c0max, code0, ok0), (c1min, c1max, code1, ok1) = _children(
            nodes, torch.where(is_internal, c, 0))
        hit0, t0 = _slab(c0min, c0max, o, inv, tl)
        hit1, t1 = _slab(c1min, c1max, o, inv, tl)
        hit0, hit1 = hit0 & ok0, hit1 & ok1
        push = is_internal & hit0 & hit1
        stacks.write(act, s, push, code1, t1)  # unordered push
        s = torch.where(push, s + 1, s)
        next_code = torch.where(hit0, code0, torch.where(hit1, code1, _POP))
        next_t = torch.where(hit0, t0, torch.where(hit1, t1, 0.0))
        start, count = _decode_leaf(torch.where(is_leaf, c, -2))
        (det, td, lo, ok, _, _, _), _, on = _leaf_terms(tris, start, count, is_leaf, o, d, ct)
        f = (on & ok & _same_sign(lo, det * (tl - ct)[:, None] - td)).any(dim=1)
        found[act] = f
        cur[act] = torch.where(is_internal, next_code, _POP)
        cur_t[act] = torch.where(is_internal, next_t, ct)
        sp[act] = s
        act = act[((cur[act] != _POP) | (sp[act] > 0)) & ~f]
    return found


def shade(normals_flat, model_rows, best, u, v):
    """The shading fetch the kernel engines fuse into their epilogue:
    ``(normal_raw [N, 3], model i32)``, the unnormalised barycentric
    interpolation of the winner's vertex normals and its model id; zeros on
    a miss."""
    hit = best >= 0
    idx = best.clamp(min=0).long()
    rows = normals_flat.index_select(0, idx)
    w = 1.0 - u - v
    n = rows[:, 0:3] * w[:, None] + rows[:, 3:6] * u[:, None] + rows[:, 6:9] * v[:, None]
    model = model_rows.index_select(0, idx)[:, 0].to(torch.int32)
    return torch.where(hit[:, None], n, 0.0), torch.where(hit, model, 0)
