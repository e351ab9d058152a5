"""The two-level gather engine: closest hit and any hit by a per-lane TLAS →
BLAS descent with per-instance rigid ray transforms, as torch ops.

Port of ``path_tracer_tpu/trace/twolevel.py`` (``pack_instances``,
``closest_hit_twolevel``, ``any_hit_twolevel``). The JAX package writes this
engine in plain XLA, not Pallas, so torch ops are its port, as for the stack
BVH (`trace.bvh_stack`, whose node and leaf helpers it shares). It takes a
two-level scene that neither two-level kernel engine holds (above iwalk's
caps), or any two-level scene on request (``PT_IWALK=0``).

Tables (`scene.twolevel_scene.gather_tables`): every model's BLAS, built once
in object space, concatenated into one ``blas_packed`` node table with
per-BLAS node and triangle offsets applied, one ``tri_packed`` plane table,
``inst_rows`` (`pack_instances`) and ``tlas_packed``, a tree over the
instances' world boxes whose leaves hold instance ids.

Each lane runs a two-phase machine over one shared stack of
``bvh_stack.STACK_DEPTH`` (node code, entry t) pairs; every loop step runs
a TLAS step and then a BLAS step, each on the lanes in that phase at the
step's start:

* TLAS: the world ray pops or descends the TLAS; on an instance leaf it
  switches to BLAS, its ray moved to object space by the instance's inverse
  rigid transform (``tlas.rs:88-98``), remembering the stack depth;
* BLAS: the object ray descends that BLAS above the saved depth, testing
  leaves' triangles on the ray moved to the leaf's entry t; when it has
  nothing left above the saved depth it returns to TLAS.

Rigid transforms keep t, so one window (the closest hit's ``t_max``) orders
hits across instances, as the reference's shared ``t_max`` does
(``tlas.rs:93-97``). The any hit pushes children unordered and a lane stops
at its first hit. The expressions and their order are the JAX package's;
each step works on the live lanes only (a lane's state never depends on
another's).
"""

from __future__ import annotations

import numpy as np
import torch

from path_tracer_tpu_torch.trace.bvh_stack import (
    _POP,
    MAX_LEAF,
    _children,
    _decode_leaf,
    _leaf_terms,
    _same_sign,
    _slab,
    _Stacks,
)

# Instance row layout [28 f32]: rot (9) | inv_rot (9) | translation (3) |
# inv_translation (3) | blas_node_root (1) | model id (1) | pad
INST_ROW_W = 28
TABLES = ("tlas_packed", "blas_packed", "inst_rows", "tri_packed", "normals_flat")


def pack_instances(matrices: np.ndarray, blas_roots: np.ndarray, model_ids: np.ndarray) -> np.ndarray:
    """``[I, 28]`` instance rows of ``matrices`` ``[I, 3, 4]`` (rigid
    object->world transforms); the root and model ids stored as exact float
    values."""
    count = matrices.shape[0]
    rows = np.zeros((count, INST_ROW_W), np.float32)
    for i in range(count):
        rot = matrices[i, :, :3]
        tr = matrices[i, :, 3]
        inv_rot = rot.T  # rigid
        inv_tr = -inv_rot @ tr
        rows[i, 0:9] = rot.reshape(-1)
        rows[i, 9:18] = inv_rot.reshape(-1)
        rows[i, 18:21] = tr
        rows[i, 21:24] = inv_tr
        rows[i, 24] = np.float32(blas_roots[i])
        rows[i, 25] = np.float32(model_ids[i])
    return rows


def _rotate(rows, col, v):
    """Rows ``rows[:, col:col+9]`` (a row-major 3x3 per lane) times ``v``,
    expanded row by row in the JAX order."""
    vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
    r = [rows[:, col + j] for j in range(9)]
    return torch.stack([r[0] * vx + r[1] * vy + r[2] * vz,
                        r[3] * vx + r[4] * vy + r[5] * vz,
                        r[6] * vx + r[7] * vy + r[8] * vz], dim=1)


def object_normal_to_world(inst_rows, inst, n_obj):
    """Object-space normals rotated to world by each hit's instance (the
    reference's deferred normal transform, ``tlas.rs:103-109``)."""
    return _rotate(inst_rows.index_select(0, inst.clamp(min=0).long()), 0, n_obj)


def _phase_step(nodes, stacks, act, on, floor, c, ct, s, o, inv, t_win, closest):
    """One pop-or-descend step of the lanes ``on`` in ``nodes``: a pop
    (never below ``floor``; the closest hit drops an entry past ``t_win``),
    then an internal node's two children slab-tested against ``t_win``,
    descending into one and pushing the other (the closest hit descends the
    nearer first). Returns ``(c, ct, s, is_leaf)``."""
    do_pop = on & (c == _POP) & (s > floor)
    s = torch.where(do_pop, s - 1, s)
    popped, popped_t = stacks.read(act, s)
    take = do_pop & (popped_t <= t_win) if closest else do_pop
    c = torch.where(take, popped, c)
    ct = torch.where(take, popped_t, ct)
    is_internal, is_leaf = on & (c >= 0), on & (c <= -2)
    (c0min, c0max, code0, ok0), (c1min, c1max, code1, ok1) = _children(
        nodes, torch.where(is_internal, c, 0))
    hit0, t0 = _slab(c0min, c0max, o, inv, t_win)
    hit1, t1 = _slab(c1min, c1max, o, inv, t_win)
    hit0, hit1 = hit0 & ok0, hit1 & ok1
    both = hit0 & hit1
    push = is_internal & both
    if closest:
        near_first = t0 <= t1
        stacks.write(act, s, push, torch.where(near_first, code1, code0),
                     torch.where(near_first, t1, t0))
        next_code = torch.where(both, torch.where(near_first, code0, code1),
                                torch.where(hit0, code0, torch.where(hit1, code1, _POP)))
        next_t = torch.where(both, torch.where(near_first, t0, t1),
                             torch.where(hit0, t0, torch.where(hit1, t1, 0.0)))
    else:
        stacks.write(act, s, push, code1, t1)  # unordered push
        next_code = torch.where(hit0, code0, torch.where(hit1, code1, _POP))
        next_t = torch.where(hit0, t0, torch.where(hit1, t1, 0.0))
    s = torch.where(push, s + 1, s)
    c = torch.where(is_internal, next_code, c)
    ct = torch.where(is_internal, next_t, ct)
    return c, ct, s, is_leaf


def _traverse(eng: dict, origin, direction, t_limit, closest: bool):
    """The phase machine; returns ``(best, t_max, best_u, best_v,
    best_inst)`` for the closest hit, ``found`` for the any hit."""
    tlas, blas, irows, tris = (eng[k] for k in TABLES[:4])
    n, dev, dt = origin.shape[0], origin.device, origin.dtype
    inv_d = 1.0 / direction
    in_blas = torch.zeros(n, dtype=torch.bool, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)  # the TLAS root, internal node 0
    cur_t = torch.zeros(n, dtype=dt, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    sp_enter = torch.zeros(n, dtype=torch.int64, device=dev)  # TLAS depth at BLAS entry
    stacks = _Stacks(n, dev, dt)
    inst = torch.full((n,), -1, dtype=torch.int64, device=dev)
    o2, d2, inv2 = origin.clone(), direction.clone(), inv_d.clone()  # the object-space ray
    t_max = t_limit.clone()
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_inst = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, dtype=dt, device=dev)
    best_v = torch.zeros(n, dtype=dt, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    act = torch.arange(n, device=dev)
    while act.numel():
        ph, c, ct, s, se = in_blas[act], cur[act], cur_t[act], sp[act], sp_enter[act]
        win = t_max[act] if closest else t_limit[act]
        # --- TLAS step (world ray) ---
        c, ct, s, tlas_leaf = _phase_step(tlas, stacks, act, ~ph, 0, c, ct, s, origin[act],
                                          inv_d[act], win, closest)
        # an instance leaf: enter its BLAS with the ray in object space
        inst_id, _ = _decode_leaf(torch.where(tlas_leaf, c, -2))
        ir = irows.index_select(0, torch.where(tlas_leaf, inst_id, 0))
        o_obj = _rotate(ir, 9, origin[act]) + ir[:, 21:24]
        d_obj = _rotate(ir, 9, direction[act])
        ent = tlas_leaf[:, None]
        ob = torch.where(ent, o_obj, o2[act])
        db = torch.where(ent, d_obj, d2[act])
        ib = torch.where(ent, 1.0 / d_obj, inv2[act])
        ins = torch.where(tlas_leaf, inst_id, inst[act])
        se = torch.where(tlas_leaf, s, se)
        c = torch.where(tlas_leaf, ir[:, 24].to(torch.int64), c)
        # --- BLAS step (object ray), on the lanes in BLAS at the step's start ---
        c, ct, s, blas_leaf = _phase_step(blas, stacks, act, ph, se, c, ct, s, ob, ib, win, closest)
        start, count = _decode_leaf(torch.where(blas_leaf, c, -2))
        (det, td, lo, ok, t, u, v), tri_idx, on = _leaf_terms(tris, start, count, blas_leaf,
                                                              ob, db, ct)
        if closest:
            bi, bu, bv, bn = best[act], best_u[act], best_v[act], best_inst[act]
            for k in range(MAX_LEAF):
                upd = on[:, k] & ok[:, k] & _same_sign(lo[:, k], det[:, k] * (win - ct) - td[:, k])
                win = torch.where(upd, t[:, k] + ct, win)
                bi = torch.where(upd, tri_idx[:, k], bi)
                bu = torch.where(upd, u[:, k], bu)
                bv = torch.where(upd, v[:, k], bv)
                bn = torch.where(upd, ins, bn)
            t_max[act], best[act], best_u[act], best_v[act], best_inst[act] = win, bi, bu, bv, bn
        c = torch.where(blas_leaf, _POP, c)
        done = ph & (c == _POP) & (s <= se)  # the BLAS is exhausted: back to the TLAS
        in_blas[act] = (ph | tlas_leaf) & ~done
        cur[act], cur_t[act], sp[act], sp_enter[act] = c, ct, s, se
        o2[act], d2[act], inv2[act], inst[act] = ob, db, ib, ins
        live = (c != _POP) | (s > 0)
        if not closest:  # a lane stops at its first hit
            hit = (on & ok & _same_sign(lo, det * (win - ct)[:, None] - td)).any(dim=1)
            found[act] = hit
            live &= ~hit
        act = act[live]
    if closest:
        return best.to(torch.int32), t_max, best_u, best_v, best_inst.to(torch.int32)
    return found


def closest_hit(eng: dict, origin, direction, t_limit):
    """Closest hit of each ray over every instance: ``(tri_idx i32, t, u, v,
    inst i32)``; ``tri_idx == inst == -1`` on a miss (t = t_limit, u = v =
    0). ``tri_idx`` indexes ``tri_packed`` / ``normals_flat`` (object
    space)."""
    return _traverse(eng, origin, direction, t_limit, closest=True)


def any_hit(eng: dict, origin, direction, t_limit):
    """True where some instance has a hit with EPSILON < t < t_limit (the
    shadow test, ``TLAS::any_intersect``)."""
    return _traverse(eng, origin, direction, t_limit, closest=False)
