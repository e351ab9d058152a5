"""Walk engine: ordered, gated closest hit and any hit over spatial chunks
of <=128 triangles, for world soups above the dense engine's 16,384
triangles. The CUDA kernels of ``csrc/walk_hit.cu``, their plain torch
versions, the host packing, and the public queries.

Port of ``path_tracer_tpu/trace/walk.py`` (``_walk_closest_kernel`` and
``_walk_any_kernel``, reached through ``walk_closest_hit_shade`` and
``walk_any_hit``):

* Host packing (`pack_walk`, bit-equal to the JAX tables it keeps): the soup
  is cut into spatially tight chunks by `scene.bvh.chunk_partition`, a SAH
  tree over the chunk boxes lays the chunks out in leaf order, and each of
  the eight direction octants gets a front-to-back chunk order
  (``ord_oct``) with the chunk boxes permuted into it (``cb_oct``). ``aux``
  holds one row per padded slot (12 plane floats, 9 vertex-normal floats,
  the model id); pad slots are zero rows that never hit. The JAX package's
  MXU-shaped plane table ``w`` and its ``PT_WALK_MASK_LAYOUT`` twins are not
  carried over: the kernels read the planes from ``aux``. One engine holds
  the whole soup: the JAX package splits soups above 196,608 triangles into
  parts because of the TPU's 16 MB of VMEM, which Hopper does not have.
* Around the kernels (plain torch ops, as they were plain XLA): the
  ``t_limit`` clamp to the exit of the scene's root box (`_exit_clamp`), the
  32-bit coherence sort key (`_coherence_order`, int64 words masked to 32
  bits) with a stable argsort, and the unsort. The any-hit query is not
  sorted (the JAX default ``WALK_SORT_ANY=0``).
* The kernels take the rays in blocks of 128, gate every chunk box
  against the block's conservative ray bounds in the octant order of the
  block's first ray, and skip an entry whose conservative entry t fails the
  block's live window (``te <= win*1.00002 + 1e-5``). Each live lane then
  runs its own segment test of every surviving box within its own window
  (`lane_enters`, exact: the chunk boxes are padded; closest:
  ``min(best, t_limit)``, any hit: ``t_limit`` while unoccluded), a chunk no
  lane enters is not staged, and only the entering lanes' (ray, triangle)
  pairs are tested. Closest: best t and the padded slot of the winner, each
  chunk's least (t, lane) merged in visit order with strict <, so ties go
  to the first visited chunk, then the lowest lane. Any hit: the
  division-free sign test; the block leaves once every live lane is
  occluded.
* Plain versions: one dense pass over every slot, ungated. The gates, the
  window and the lanes' cull are conservative, so the closest winner is
  the slot at the minimum t that comes first in the ray's block octant
  order (rank = position in ``ord_oct`` * 128 + lane): the walk's winner,
  ties included. `lane_enters` is the plain model of the kernels' segment
  cull, and `culled_closest_plain` / `culled_any_plain` the queries through
  it, which the tests hold equal to the ungated plain versions.

Each kernel has one wrapper: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises. ``LAUNCHES["walk_closest"]`` and
``LAUNCHES["walk_any"]`` count the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from path_tracer_tpu_torch.core.constants import EPSILON
from path_tracer_tpu_torch.scene import triangle as tri_mod
from path_tracer_tpu_torch.scene.bvh import build_sah_tree, chunk_partition
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES, load
from path_tracer_tpu_torch.trace.dense_cuda import AUX_COLS, _epilogue, _same, _valid

CH_W = 128  # chunk capacity (tris per leaf test)
SBLK = 128  # rays per block
WALK_PARTS_MAX_TRIS = 1_572_864  # the engine's limit
# live t-window admit test: te <= win * WIN_MUL + WIN_ADD (csrc/segment.cuh)
WIN_MUL = 1.00002
WIN_ADD = 1e-5
NSTATS = 6  # the kernels' counters before their per-entry flags
_BIG = 1e30  # "no winner" sentinel
_T_CLAMP = 3.0e38  # finite stand-in for an infinite t_limit
_KEY_OBITS = 15  # origin morton bits of the coherence key (5 per axis)
# [rays, slots] pairs per step of the plain versions (bounds their memory)
_PLAIN_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 25}


# --- host packing (NumPy) ---


def _octant_orders(nodes, root, k) -> np.ndarray:
    """Front-to-back DFS leaf order per direction octant, [8, k] i32.

    At each internal node the child whose box center is nearer along the
    octant's dominant separating axis is visited first — the static
    resolution of the reference's per-ray near-child push (blas.rs:133-162).
    Octant bit encoding matches _coherence_order: bit2 x<0, bit1 y<0,
    bit0 z<0.
    """
    orders = np.empty((8, k), np.int32)
    for o in range(8):
        sign = np.array(
            [-1.0 if o & 4 else 1.0,
             -1.0 if o & 2 else 1.0,
             -1.0 if o & 1 else 1.0]
        )
        out = []
        stack = [root]
        while stack:
            n = nodes[stack.pop()]
            if n.is_leaf:
                out.append(n.a)  # span-1 leaf: start == layout slot
                continue
            a, b = nodes[n.a], nodes[n.b]
            ca = (a.bb_min + a.bb_max) * sign
            cb = (b.bb_min + b.bb_max) * sign
            axis = int(np.argmax(np.abs(cb - ca)))
            a_first = ca[axis] <= cb[axis]
            near, far = (n.a, n.b) if a_first else (n.b, n.a)
            stack.append(far)
            stack.append(near)
        orders[o] = out
    return orders


def _ragged_arange(spans: np.ndarray) -> np.ndarray:
    """[0..spans[0]) ++ [0..spans[1]) ++ ... as one flat int64 array."""
    total = int(spans.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    seg0 = np.zeros(len(spans), np.int64)
    seg0[1:] = np.cumsum(spans[:-1])
    return np.arange(total, dtype=np.int64) - np.repeat(seg0, spans)


def pack_walk(tri: dict, normals_flat, model, positions) -> dict:
    """Pack the walk-engine tables (host numpy).

    Returns ``cb_oct`` [8, 6, kq] per-octant PERMUTED chunk AABBs (rows lo
    xyz | hi xyz; padded columns are 2e30 point boxes); ``ord_oct`` [8, kq]
    per-octant front-to-back chunk orders (layout slots, 0 for pads);
    ``aux`` [nchunks*CH_W, AUX_COLS] plane + shading rows in padded slot
    order (zero pad rows); ``origmap`` [nchunks*CH_W] i32 original soup
    index per slot (0 for pads); ``sort_lo``/``sort_scale`` [3] scene-bounds
    quantizers for the coherence sort; ``root_lo``/``root_hi`` the scene
    box for the t_limit exit clamp. ``kq`` = 128 * ceil(nchunks/128).
    """
    pos = np.asarray(positions, np.float32)
    t = pos.shape[0]
    if t > WALK_PARTS_MAX_TRIS:
        raise ValueError(f"walk engine caps at {WALK_PARTS_MAX_TRIS} tris, got {t}")
    bmin = pos.min(axis=1)
    bmax = pos.max(axis=1)
    perm, starts, spans = chunk_partition(bmin, bmax, CH_W)
    k = len(starts)
    pad = 1e-4 * float(np.abs(pos).max(initial=1.0)) + 1e-6

    # chunk AABBs in partition DFS order — chunks tile [0, t) contiguously
    cmin = np.minimum.reduceat(bmin[perm], starts, axis=0) - pad
    cmax = np.maximum.reduceat(bmax[perm], starts, axis=0) + pad

    # global SAH tree over chunk boxes; chunks laid out in tree leaf order
    # (leaf c_idx == layout slot because every leaf has span 1)
    nodes, perm2, root = build_sah_tree(cmin, cmax, max_leaf=1)
    ord_oct = _octant_orders(nodes, root, k)

    # original soup index per padded layout slot (vectorized ragged scatter)
    S = k * CH_W
    slots = np.full(S, -1, np.int64)
    gc = np.asarray(perm2)
    seg_spans = np.asarray(spans)[gc]
    within = _ragged_arange(seg_spans)
    rows = np.repeat(np.arange(k, dtype=np.int64) * CH_W, seg_spans) + within
    src = np.repeat(np.asarray(starts)[gc], seg_spans) + within
    slots[rows] = perm[src]
    valid = slots >= 0
    idx = slots[valid]

    def fld(name):
        return np.asarray(tri[name], np.float32)

    aux = np.zeros((S, AUX_COLS), np.float32)
    a = aux[valid]
    a[:, 0:3] = fld("n0")[idx]
    a[:, 3] = fld("d0")[idx]
    a[:, 4:7] = fld("n1")[idx]
    a[:, 7] = fld("d1")[idx]
    a[:, 8:11] = fld("n2")[idx]
    a[:, 11] = fld("d2")[idx]
    if normals_flat is not None:
        a[:, 12:21] = np.asarray(normals_flat, np.float32)[idx]
    if model is not None:
        a[:, 21] = np.asarray(model)[idx]
    aux[valid] = a

    # chunk boxes in LAYOUT order, then per-octant permuted + padded
    cb_lo = cmin[perm2].astype(np.float32)
    cb_hi = cmax[perm2].astype(np.float32)
    kq = ((k + 127) // 128) * 128
    cb_oct = np.full((8, 6, kq), 2.0e30, np.float32)
    ord_pad = np.zeros((8, kq), np.int32)
    for o in range(8):
        po = ord_oct[o]
        cb_oct[o, 0:3, :k] = cb_lo[po].T
        cb_oct[o, 3:6, :k] = cb_hi[po].T
        ord_pad[o, :k] = po

    scene_lo = bmin.min(axis=0)
    scene_hi = bmax.max(axis=0)
    extent = np.maximum(scene_hi - scene_lo, 1e-6)
    return {
        "cb_oct": cb_oct,
        "ord_oct": ord_pad,
        "aux": aux,
        "origmap": np.maximum(slots, 0).astype(np.int32),
        "sort_lo": scene_lo.astype(np.float32),
        "sort_scale": (1.0 / extent).astype(np.float32),
        # root box for the per-ray t_limit exit clamp: a ray that misses or
        # exits the scene box stops holding its block's live t-window open
        "root_lo": (scene_lo - pad).astype(np.float32),
        "root_hi": (scene_hi + pad).astype(np.float32),
    }


def num_chunks(eng: dict) -> int:
    return eng["aux"].shape[0] // CH_W


# --- around the kernels (torch ops) ---


def _exit_clamp(eng, origin, direction, t_limit):
    """Clamp per-ray t_limit to the scene root-box EXIT t (with conservative
    slack); rays that miss the box entirely become dead (t_limit 0). Sound:
    no triangle lies beyond the root box, and without this one miss ray per
    block pins the live t-window at its full t_limit forever."""
    lo, hi = eng["root_lo"], eng["root_hi"]
    d0 = direction == 0.0
    inv = 1.0 / torch.where(d0, 1.0, direction)
    t1 = (lo - origin) * inv
    t2 = (hi - origin) * inv
    inside = (origin >= lo) & (origin <= hi)
    hi_a = torch.where(d0, torch.where(inside, _BIG, -_BIG), torch.maximum(t1, t2))
    lo_a = torch.where(d0, torch.where(inside, -_BIG, _BIG), torch.minimum(t1, t2))
    tf = hi_a.min(dim=1).values
    tn = torch.clamp(lo_a.max(dim=1).values, min=0.0)
    texit = torch.where(tf >= tn, tf * 1.0001 + 1e-4, 0.0)
    return torch.minimum(t_limit, texit)


def _spread3(x):
    """Interleave an 8-bit value into every 3rd bit (morton part1by2)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _spread2(x):
    """Interleave an 8-bit value into every 2nd bit (morton part1by1)."""
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _coherence_order(eng, origin, direction, t_limit):
    """Stable sort order of the 32-bit key: direction octant (3) | origin
    morton (15: 5/axis) | direction-octahedral morton (14: 7+7). Keys are
    int64 holding the uint32 values; invalid lanes sort to the back."""
    i64 = torch.int64
    q = torch.clamp((origin - eng["sort_lo"]) * eng["sort_scale"], 0.0, 1.0)
    bx, by, bz = (_KEY_OBITS + 2) // 3, (_KEY_OBITS + 1) // 3, _KEY_OBITS // 3
    valid = _valid(origin, direction, t_limit)
    # NaN lanes are invalid: zero them so the casts below stay defined
    q = torch.where(valid[:, None], q, 0.0)
    cx = (q[:, 0] * float((1 << bx) - 1)).to(i64)
    cy = (q[:, 1] * float((1 << by) - 1)).to(i64)
    cz = (q[:, 2] * float((1 << bz) - 1)).to(i64)
    om = (_spread3(cx) << 2) | (_spread3(cy) << 1) | _spread3(cz)
    ad = torch.where(valid[:, None], direction.abs(), 0.0)
    s = ad[:, 0] + ad[:, 1] + ad[:, 2]
    s = torch.where(s > 0, s, 1.0)
    u = (ad[:, 0] / s * 127.0).to(i64)
    v = (ad[:, 1] / s * 127.0).to(i64)
    dm = (_spread2(u) << 1) | _spread2(v)
    key = (_octant(direction) << 29) | (om << 14) | dm
    key = torch.where(valid, key, 0xFFFFFFFF)
    return torch.argsort(key, stable=True)


def _unsort_rows(x, order):
    """Undo the permutation ``order`` on the leading axis of ``x``."""
    out = torch.empty_like(x)
    out[order] = x
    return out


def _lanes(origin, direction, t_limit):
    """The kernels' lane values: invalid lanes zeroed with t_limit 0 (zero
    direction -> det == 0 -> no hit anywhere), t_limit clamped finite."""
    valid = _valid(origin, direction, t_limit)
    o = torch.where(valid[:, None], origin, 0.0)
    d = torch.where(valid[:, None], direction, 0.0)
    tl = torch.where(valid, torch.clamp(t_limit, max=_T_CLAMP), 0.0)
    return o, d, tl


def _octant(direction):
    """Direction octant: bit2 x<0, bit1 y<0, bit0 z<0 (int64)."""
    neg = (direction < 0).to(torch.int64)
    return (neg[:, 0] << 2) | (neg[:, 1] << 1) | neg[:, 2]


def _block_octant(direction):
    """Octant of the first ray of each ray's block of SBLK (raw direction;
    the octant steers visit order, never correctness)."""
    first = (torch.arange(direction.shape[0], device=direction.device) // SBLK) * SBLK
    return _octant(direction.index_select(0, first))


# --- kernel binding ---


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return load("walk_hit", {
        "walk_closest": [i, p, p, p, i, i, p, p, p, i, p, p, p, p],
        "walk_any": [i, p, p, p, i, i, p, p, p, i, p, p, p],
    })


def _check_cuda(eng, origin, direction, t_limit):
    dev = origin.device
    for name, x, dtype in (
        ("aux", eng["aux"], torch.float32), ("cb_oct", eng["cb_oct"], torch.float32),
        ("ord_oct", eng["ord_oct"], torch.int32), ("origin", origin, torch.float32),
        ("direction", direction, torch.float32), ("t_limit", t_limit, torch.float32),
    ):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != dev:
            raise ValueError("all tensors must be on one device")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}")
    aux, cb, od = eng["aux"], eng["cb_oct"], eng["ord_oct"]
    if aux.data_ptr() % 16:
        raise ValueError("aux must be 16-byte aligned (the kernels read it as float4)")
    if aux.dim() != 2 or aux.shape[1] != AUX_COLS or aux.shape[0] % CH_W:
        raise ValueError(f"aux must be [k*{CH_W}, {AUX_COLS}], got {tuple(aux.shape)}")
    kq = od.shape[-1]
    if od.shape != (8, kq) or cb.shape != (8, 6, kq) or num_chunks(eng) > kq:
        raise ValueError("ord_oct must be [8, kq] and cb_oct [8, 6, kq], kq >= chunks")
    n = origin.shape[0]
    if origin.shape != (n, 3) or direction.shape != (n, 3) or t_limit.shape != (n,):
        raise ValueError("origin/direction must be [N, 3] and t_limit [N]")


def _tables(eng):
    return (eng["aux"].data_ptr(), eng["cb_oct"].data_ptr(), eng["ord_oct"].data_ptr(),
            num_chunks(eng), eng["ord_oct"].shape[1])


def _check_stats(eng, origin, stats):
    if stats is not None and (stats.device != origin.device or stats.dtype != torch.int64
                              or stats.shape != (NSTATS + num_chunks(eng),)):
        raise ValueError(f"stats must be an int64 [{NSTATS} + chunks] tensor on the rays' device")
    return None if stats is None else stats.data_ptr()


def closest_cuda(eng, origin, direction, t_limit, stats=None):
    """Kernel closest hit over rays in sorted order (raw origin/direction,
    exit-clamped t_limit). Returns ``(best_t [N] f32, slot [N] i32)``,
    best_t = 1e30 and slot = -1 on a miss. ``stats``, a zeroed int64 CUDA
    tensor [6 + chunks], receives (blocks with a live lane, gate survivors
    admitted by the block window, those the window skipped, lanes that
    entered a staged chunk, chunks staged, (lane, real triangle) pairs
    tested) summed over blocks, then a 1 for every chunk staged."""
    _check_cuda(eng, origin, direction, t_limit)
    stats_ptr = _check_stats(eng, origin, stats)
    fn = _lib().walk_closest
    n = origin.shape[0]
    best_t = torch.empty(n, dtype=torch.float32, device=origin.device)
    slot = torch.empty(n, dtype=torch.int32, device=origin.device)
    dev = origin.device
    LAUNCHES["walk_closest"] += 1
    err = fn(dev.index, *_tables(eng), origin.data_ptr(), direction.data_ptr(),
             t_limit.data_ptr(), n, best_t.data_ptr(), slot.data_ptr(), stats_ptr,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"walk_closest launch failed: cudaError {err}")
    return best_t, slot


def any_cuda(eng, origin, direction, t_limit, stats=None):
    """Kernel shadow test (raw origin/direction, exit-clamped t_limit): bool
    ``[N]``, False on dead and non-finite lanes. ``stats`` as for
    `closest_cuda`, counting (blocks with a live lane, gate survivors
    admitted by the block window, those the window skipped, lanes that
    entered a staged chunk, chunks staged, (lane, real triangle) pairs
    tested), then a 1 for every chunk staged."""
    _check_cuda(eng, origin, direction, t_limit)
    stats_ptr = _check_stats(eng, origin, stats)
    fn = _lib().walk_any
    n = origin.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=origin.device)
    dev = origin.device
    LAUNCHES["walk_any"] += 1
    err = fn(dev.index, *_tables(eng), origin.data_ptr(), direction.data_ptr(),
             t_limit.data_ptr(), n, out.data_ptr(), stats_ptr,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"walk_any launch failed: cudaError {err}")
    return out


# --- plain torch versions (same expressions, same order, ungated) ---


def _walk_terms(planes, o, d):
    """p-form Havel-Herout terms (det, td, ud, vd) as ``[n, S]`` for rays
    ``o, d [n, 3]`` x plane rows ``[S, >=12]``, in walk_hit.cu's (and the
    JAX ``_chunk_terms``) expression order."""
    a = planes.T[:, None, :]  # [cols, 1, S]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    det = a[0] * dx + a[1] * dy + a[2] * dz
    td = a[3] - (a[0] * ox + a[1] * oy + a[2] * oz)
    px = det * ox + td * dx
    py = det * oy + td * dy
    pz = det * oz + td * dz
    ud = a[4] * px + a[5] * py + a[6] * pz + det * a[7]
    vd = a[8] * px + a[9] * py + a[10] * pz + det * a[11]
    return det, td, ud, vd


def _order_positions(ord_oct, k, n_ids, device):
    """``[8, n_ids]`` position of each id in the first ``k`` columns of each
    octant's order ``ord_oct`` (``k`` for an id that is not among them)."""
    ordk = ord_oct[:, :k].to(device=device, dtype=torch.int64)
    inv = torch.full((8, n_ids), k, dtype=torch.int64, device=device)
    return inv.scatter_(1, ordk, torch.arange(k, device=device).expand(8, k))


def _rank_table(eng, device):
    """``[8, S]`` visit rank of every slot in each octant's order:
    position in ``ord_oct`` * CH_W + lane."""
    k = num_chunks(eng)
    inv = _order_positions(eng["ord_oct"], k, k, device)
    s = torch.arange(k * CH_W, device=device)
    return inv[:, s // CH_W] * CH_W + s % CH_W


def _candidate_t(planes, o, d, tl):
    """``[n, S]`` candidate t of rays ``o, d [n, 3]`` (limits ``tl [n, 1]``)
    against plane rows ``[S, >=12]``, ``_BIG`` where there is no hit: the
    closest kernels' arithmetic (exact reciprocal, one Newton step)."""
    det, td, ud, vd = _walk_terms(planes, o, d)
    c2 = _same(ud, det - ud)
    c3 = _same(vd, det - ud - vd)
    safe = torch.where(det == 0.0, 1.0, det)
    r = 1.0 / safe
    r = r * (2.0 - safe * r)  # one Newton step, as on the TPU
    t = td * r
    ok = c2 & c3 & (det != 0.0) & (t > EPSILON) & (t < tl)
    return torch.where(ok, t, _BIG)


def _shadow_hits(planes, o, d, tl):
    """``[n, S]`` shadow-test verdicts, the any-hit kernels' division-free
    sign tests (arguments as for `_candidate_t`)."""
    det, td, ud, vd = _walk_terms(planes, o, d)
    c1 = _same(td - det * EPSILON, det * tl - td)
    c2 = _same(ud, det - ud)
    c3 = _same(vd, det - ud - vd)
    return c1 & c2 & c3 & (det != 0.0)


def _closest_columns(tm, rank, octs):
    """(minimum t, winning column) of each row of ``tm [n, S]``: among the
    columns at the minimum t, the one of lowest visit rank
    (``rank [8, S]`` at the row's block octant ``octs [n]``) wins, as in the
    kernels (strict < over the visit order)."""
    bt = tm.min(dim=1).values
    at_min = tm == bt[:, None]
    first = torch.argmax(at_min.to(torch.uint8), dim=1)
    # a tie (two columns at the minimum t): the first in visit order wins
    tie = ((at_min.sum(dim=1) > 1) & (bt < _BIG)).nonzero()[:, 0]
    if tie.numel():
        cand = torch.where(at_min[tie], rank[octs[tie]], torch.iinfo(torch.int64).max)
        first[tie] = cand.argmin(dim=1)
    return bt, first


def _live_steps(eng, origin, direction, t_limit):
    """The plain versions' work list: the lane values of the live lanes only
    (a dead lane cannot hit), their row indices, and steps of them bounded
    by the pairs budget."""
    o, d, tl = _lanes(origin, direction, t_limit)
    live = (tl > 0.0).nonzero()[:, 0]
    planes = eng["aux"][:, :12].to(origin.dtype)
    step = max(1, _PLAIN_PAIRS[origin.device.type] // planes.shape[0])
    o, d, tl = o[live], d[live], tl[live]
    return planes, live, [(o[s : s + step], d[s : s + step], tl[s : s + step, None], s)
                          for s in range(0, live.numel(), step)]


def closest_plain(eng, origin, direction, t_limit):
    """Plain version of `closest_cuda` (any device, any float dtype: run in
    float64 it is the precision oracle)."""
    n, dev = origin.shape[0], origin.device
    planes, live, steps = _live_steps(eng, origin, direction, t_limit)
    oct_live = _block_octant(direction)[live]
    rank = _rank_table(eng, dev) if steps else None
    best_t = torch.full((n,), _BIG, dtype=origin.dtype, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for o, d, tl, s in steps:
        bt, first = _closest_columns(_candidate_t(planes, o, d, tl), rank, oct_live[s : s + o.shape[0]])
        rows = live[s : s + o.shape[0]]
        best_t[rows] = bt
        slot[rows] = torch.where(bt < _BIG, first, -1).to(torch.int32)
    return best_t, slot


def any_plain(eng, origin, direction, t_limit):
    """Plain version of `any_cuda`: an ungated OR over every slot."""
    planes, live, steps = _live_steps(eng, origin, direction, t_limit)
    out = torch.zeros(origin.shape[0], dtype=torch.bool, device=origin.device)
    for o, d, tl, s in steps:
        out[live[s : s + o.shape[0]]] = _shadow_hits(planes, o, d, tl).any(dim=1)
    return out


# --- the kernels' segment cull, as a plain model (tests, chip_smoke.py) ---


def lane_enters(lo, hi, o, d, tw):
    """``[n, E]``: whether each ray ``o, d [n, 3]`` meets each box ``lo, hi
    [E, 3]`` within ``[0, tw*WIN_MUL + WIN_ADD]`` (``tw [n]``), the walk
    kernels' per-lane segment test (``csrc/segment.cuh`` enters) in its
    expressions and order: fmin/fmax ignore a NaN as fminf/fmaxf do, an
    inverted box is never entered, and on an axis where the direction is 0
    the origin must lie within the slab."""
    d0 = d == 0.0
    inv = torch.where(d0, 0.0, 1.0 / torch.where(d0, 1.0, d))
    t_near = torch.zeros((o.shape[0], lo.shape[0]), dtype=o.dtype, device=o.device)
    t_far = (tw * WIN_MUL + WIN_ADD)[:, None].expand_as(t_near)
    ok = (lo <= hi).all(dim=1)[None, :].expand_as(t_near)
    for a in range(3):
        oa, za, ia = o[:, a : a + 1], d0[:, a : a + 1], inv[:, a : a + 1]
        t1 = (lo[:, a] - oa) * ia
        t2 = (hi[:, a] - oa) * ia
        ok = ok & (~za | ((oa >= lo[:, a]) & (oa <= hi[:, a])))
        t_near = torch.where(za, t_near, torch.fmax(t_near, torch.fmin(t1, t2)))
        t_far = torch.where(za, t_far, torch.fmin(t_far, torch.fmax(t1, t2)))
    return ok & (t_near <= t_far)


def chunk_boxes(eng):
    """The gate boxes of the layout chunks: ``(lo, hi)`` [k, 3], chunk c's
    box at row c (octant 0's columns put back in layout order)."""
    k = num_chunks(eng)
    cols = eng["ord_oct"][0, :k].long()
    lo = torch.empty((k, 3), dtype=eng["cb_oct"].dtype, device=cols.device)
    hi = torch.empty_like(lo)
    lo[cols] = eng["cb_oct"][0, 0:3, :k].T
    hi[cols] = eng["cb_oct"][0, 3:6, :k].T
    return lo, hi


def culled_closest_plain(eng, origin, direction, t_limit):
    """The closest hit through the kernels' segment cull at its tightest: a
    lane tests a chunk's slots only if `lane_enters` passes its box within
    ``min(t*, t_limit)``, t* the lane's plain closest t (the least window a
    kernel lane can reach). Equal to `closest_plain` when the cull is
    exact."""
    n, dev = origin.shape[0], origin.device
    lo, hi = chunk_boxes(eng)
    t_star, _ = closest_plain(eng, origin, direction, t_limit)
    planes, live, steps = _live_steps(eng, origin, direction, t_limit)
    oct_live = _block_octant(direction)[live]
    rank = _rank_table(eng, dev) if steps else None
    best_t = torch.full((n,), _BIG, dtype=origin.dtype, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for o, d, tl, s in steps:
        rows = live[s : s + o.shape[0]]
        enter = lane_enters(lo, hi, o, d, torch.minimum(t_star[rows], tl[:, 0]))
        tm = torch.where(enter.repeat_interleave(CH_W, dim=1), _candidate_t(planes, o, d, tl), _BIG)
        bt, first = _closest_columns(tm, rank, oct_live[s : s + o.shape[0]])
        best_t[rows] = bt
        slot[rows] = torch.where(bt < _BIG, first, -1).to(torch.int32)
    return best_t, slot


def culled_any_plain(eng, origin, direction, t_limit):
    """The any hit through the kernels' segment cull: a lane tests a
    chunk's slots only if `lane_enters` passes its box within the lane's
    t_limit. Equal to `any_plain` when the cull is exact."""
    lo, hi = chunk_boxes(eng)
    planes, live, steps = _live_steps(eng, origin, direction, t_limit)
    out = torch.zeros(origin.shape[0], dtype=torch.bool, device=origin.device)
    for o, d, tl, s in steps:
        hits = _shadow_hits(planes, o, d, tl).view(o.shape[0], -1, CH_W).any(dim=2)
        out[live[s : s + o.shape[0]]] = (hits & lane_enters(lo, hi, o, d, tl[:, 0])).any(dim=1)
    return out


def tie_soup(seed: int = 0, n: int = 2047):
    """A soup and rays on which every winner ties (tests, chip_smoke.py):
    ``n`` small triangles scattered in [-1, 1]^3 outside the ball of radius
    0.25, then triangle T (index ``n``) at the origin; 1,024 rays in eight
    blocks of 128, block b's directions in octant b (bit2 x<0, bit1 y<0,
    bit0 z<0) and at least 17 degrees off T's plane, each from 0.1 before a
    point inside T, so that T is every ray's closest hit. Returns
    (positions [n+1, 3, 3], origin [1024, 3], direction [1024, 3]), float32
    NumPy."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (4 * n, 3))
    c = c[np.linalg.norm(c, axis=1) > 0.25][:n]
    tri_t = np.array([[-0.05, -0.04, 0.01], [0.05, -0.03, -0.02], [0.0, 0.06, 0.02]])
    pos = np.concatenate([c[:, None, :] + rng.normal(scale=0.01, size=(n, 3, 3)), tri_t[None]])
    normal = np.cross(tri_t[1] - tri_t[0], tri_t[2] - tri_t[0])
    normal /= np.linalg.norm(normal)
    sign = 1.0 - 2.0 * ((np.arange(8)[:, None] >> np.array([2, 1, 0])) & 1)
    d = []
    for b in range(8):
        v = np.abs(rng.normal(size=(1024, 3))) * sign[b]
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        d.append(v[np.abs(v @ normal) > 0.3][:SBLK])
    d = np.concatenate(d)
    target = rng.dirichlet([4.0, 4.0, 4.0], size=d.shape[0]) @ tri_t
    return pos.astype(np.float32), (target - 0.1 * d).astype(np.float32), d.astype(np.float32)


def tie_tables(positions, index: int):
    """`pack_walk` tables of the soup ``positions`` with triangle ``index``
    also copied into the first two pad slots of another chunk B (tests,
    chip_smoke.py): one triangle in two chunks and twice within one. B is,
    among the chunks with two pad slots, one that the octant orders put
    before the triangle's own chunk A about as often as after it; B's box
    grows to hold A's in every octant's columns, so the gates stay exact.
    Returns (tables, the three slots that hold the triangle)."""
    pos = np.asarray(positions, np.float32)
    tables = pack_walk(tri_mod.precompute(pos), None, None, pos)
    aux, cb, orders = tables["aux"], tables["cb_oct"], tables["ord_oct"]
    k = aux.shape[0] // CH_W
    real = (aux[:, :12] != 0).any(axis=1).reshape(k, CH_W)
    src = int(np.flatnonzero((tables["origmap"] == index) & real.reshape(-1))[0])
    a = src // CH_W
    at = np.argsort(orders[:, :k], axis=1)  # [8, k] position of each chunk
    before = (at < at[:, a : a + 1]).sum(axis=0)  # octants that visit c before A
    cand = np.flatnonzero(real.sum(axis=1) <= CH_W - 2)
    cand = cand[cand != a]
    b = int(cand[np.argmin(np.abs(before[cand] - 4))])
    dst = [b * CH_W + int(real[b].sum()) + i for i in range(2)]
    aux[dst] = aux[src]
    tables["origmap"][dst] = tables["origmap"][src]
    for o in range(8):
        pa, pb = at[o, a], at[o, b]
        cb[o, 0:3, pb] = np.minimum(cb[o, 0:3, pb], cb[o, 0:3, pa])
        cb[o, 3:6, pb] = np.maximum(cb[o, 3:6, pb], cb[o, 3:6, pa])
    return tables, (src, *dst)


# --- public queries (the JAX walk_* contracts) ---


def _f32(origin, direction, t_limit):
    f32 = torch.float32
    return origin.to(f32).contiguous(), direction.to(f32).contiguous(), t_limit.to(f32).contiguous()


def _sorted_rays(eng, origin, direction, t_limit):
    """(order, sorted origin, sorted direction, sorted exit-clamped
    t_limit): the kernels' inputs. The key reads the caller's t_limit, as
    the JAX package sorts before it clamps."""
    order = _coherence_order(eng, origin, direction, t_limit)
    o_s = origin.index_select(0, order).contiguous()
    d_s = direction.index_select(0, order).contiguous()
    tl_s = _exit_clamp(eng, o_s, d_s, t_limit.index_select(0, order)).contiguous()
    return order, o_s, d_s, tl_s


def walk_closest_hit_shade(eng: dict, origin, direction, t_limit):
    """Closest hit + shading attributes: ``(tri_idx i32, t, u, v,
    normal_raw [N,3], model i32)`` — tri_idx in ORIGINAL soup order, -1 on
    a miss (t = t_limit, u = v = 0, zero normal and model)."""
    o, d, tl = _f32(origin, direction, t_limit)
    order, o_s, d_s, tl_s = _sorted_rays(eng, o, d, tl)
    if o.device.type == "cpu":
        _, slot = closest_plain(eng, o_s, d_s, tl_s)
    else:
        _, slot = closest_cuda(eng, o_s, d_s, tl_s)
    slot = _unsort_rows(slot, order)
    out = _epilogue(eng["aux"], slot, o, d)
    hit = slot >= 0
    t = torch.where(hit, out[:, 0], tl)
    u = torch.where(hit, out[:, 2], 0.0)
    v = torch.where(hit, out[:, 3], 0.0)
    orig = torch.where(hit, eng["origmap"].index_select(0, slot.clamp(min=0)), -1)
    return orig, t, u, v, out[:, 4:7], out[:, 7].to(torch.int32)


def walk_closest_hit(eng: dict, origin, direction, t_limit):
    """The closest hit without the shading attributes: ``(tri_idx, t, u,
    v)``, the contract of `traversal.closest_hit`."""
    return walk_closest_hit_shade(eng, origin, direction, t_limit)[:4]


def walk_any_hit(eng: dict, origin, direction, t_limit) -> torch.Tensor:
    """True where a hit with EPSILON < t < t_limit exists (unsorted rays)."""
    o, d, tl = _f32(origin, direction, t_limit)
    tl = _exit_clamp(eng, o, d, tl).contiguous()
    if o.device.type == "cpu":
        return any_plain(eng, o, d, tl)
    return any_cuda(eng, o, d, tl)


def walk_stats(eng: dict, origin, direction, t_limit, query: str = "closest") -> dict:
    """Gate economics of one ``query`` ("closest" or "any") on the card, with
    the public query's ray order (the closest hit's coherence sort; any hit
    unsorted): ``blocks`` (with a live lane), ``visits`` (gate survivors a
    block admitted by its live window), ``skipped`` (gated survivors the
    live window skipped), ``lane_visits`` (lanes testing a staged chunk:
    those whose own segment test entered it, and for the any hit that were
    not yet occluded), ``staged`` (chunks staged), ``pairs`` (the (lane,
    real triangle) pair tests), summed over blocks, and ``chunks``
    (distinct chunks staged). A port of the JAX ``walk_stats``; CUDA
    tensors only."""
    o, d, tl = _f32(origin, direction, t_limit)
    stats = torch.zeros(NSTATS + num_chunks(eng), dtype=torch.int64, device=o.device)
    if query == "closest":
        _, o_s, d_s, tl_s = _sorted_rays(eng, o, d, tl)
        closest_cuda(eng, o_s, d_s, tl_s, stats=stats)
    else:
        any_cuda(eng, o, d, _exit_clamp(eng, o, d, tl).contiguous(), stats=stats)
    blocks, visits, skipped, lane_visits, staged, pairs = (int(x) for x in stats[:NSTATS].cpu())
    return {"blocks": blocks, "visits": visits, "skipped": skipped, "lane_visits": lane_visits,
            "staged": staged, "pairs": pairs, "chunks": int(stats[NSTATS:].sum())}
