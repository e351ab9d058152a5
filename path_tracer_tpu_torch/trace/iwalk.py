"""Two-level engines: closest hit and any hit through per-instance rigid
transforms over shared object-space chunk tables, for scenes built with
``two_level=True``. The CUDA kernels of ``csrc/iwalk_hit.cu``, their plain
torch versions, the host packing, and the public queries.

Port of ``path_tracer_tpu/trace/iwalk.py`` (``_vwalk_closest_kernel``,
``_vwalk_any_kernel``, ``_iwalk_closest_kernel`` and ``_iwalk_any_kernel``,
reached through ``iwalk_closest_hit_shade`` and ``iwalk_any_hit``):

* Host packing (`pack_vwalk`, `pack_iwalk`; the tables they keep are
  bit-equal to the JAX ones). Each model's chunk tables are built once in
  object space (`model_tables`) and shared by its instances: that is the
  memory two-level saves. ``inst_f [I, 12]`` holds each instance's inverse
  rigid transform, ``inst_rows [I, 24]`` the inverse, the forward rotation
  (for normals) and the model id.
* vwalk, the default: every (instance, object chunk) pair is a virtual
  chunk whose gate box is the object chunk box's 8 corners through the
  instance transform; the virtual chunks get the walk's SAH octant orders,
  and one gated visit tests one object chunk of one instance.
* iwalk, above vwalk's cap of `VWALK_MAX_VCH` virtual chunks or on request:
  the gate works on instance world boxes; under an admitted instance each
  lane culls the model's object parts (runs of at most `PART_W` chunks)
  and object chunks on its object-space ray. Those boxes are port-only
  tables (`pack_object_boxes`, built by `upload` from ``aux`` and
  ``inst_c``: ``ocb``, ``opb``, ``part_c``, ``inst_p``); the tables
  `pack_iwalk` returns stay the JAX ones.
* The JAX package splits both engines into parts because a part's plane
  table must fit the TPU's VMEM; on Hopper the kernels read one table from
  device memory, so there are no parts, and the plane table ``w``, the
  part-local ``vchunk`` compaction and the mask-layout twins are not
  carried over. The engines' limits stay, so a scene takes the same engine
  in both packages.
* Around the kernels: the walk's coherence sort, exit clamp and unsort
  (`trace.walk`); the epilogue recomputes the winner's object-space ray in
  the transform's order, then t/u/v from its ``aux`` row, and rotates the
  interpolated object normal to world by the forward rotation (the
  reference's deferred normal transform, ``tlas.rs:103-109``).
* Plain versions: one ungated pass over every (instance, object chunk)
  pair. Closest: minimum t; among ties the first in the kernel's visit
  order wins (vwalk: position of the virtual chunk in the ray block's
  octant order, then lane; iwalk: position of the instance, then chunk,
  then lane). Any hit: an OR. `culled_closest_plain` / `culled_any_plain`
  are the queries through each kernel's per-lane cull (vwalk: the widened
  virtual chunk boxes; iwalk: the widened instance box, then the object
  part and chunk boxes), which the tests hold equal to the plain versions.

Each kernel has one wrapper: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises. ``LAUNCHES["vwalk_closest"]``,
``["vwalk_any"]``, ``["iwalk_closest"]`` and ``["iwalk_any"]`` count the
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from path_tracer_tpu_torch.scene import triangle as tri_mod
from path_tracer_tpu_torch.scene.bvh import build_sah_tree, chunk_partition
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES, load
from path_tracer_tpu_torch.trace.dense_cuda import AUX_COLS, _epilogue, _valid
from path_tracer_tpu_torch.trace.walk import (
    _BIG,
    _PLAIN_PAIRS,
    CH_W,
    NSTATS,
    _block_octant,
    _candidate_t,
    _closest_columns,
    _exit_clamp,
    _f32,
    _lanes,
    _octant_orders,
    _order_positions,
    _ragged_arange,
    _shadow_hits,
    _sorted_rays,
    _unsort_rows,
    lane_enters,
)

VWALK_MAX_VCH = 16 * 1536  # vwalk's limit: 24,576 virtual chunks
IWALK_MAX_TOTAL_CHUNKS = 16 * 768  # iwalk's limit: 12,288 object chunks
IWALK_MAX_OBJECT_TRIS = 1_000_000  # either engine's limit on object tris
# the tables each engine keeps (the JAX packers' keys less w, vchunk and
# the mask-layout twins cb_lay / pos_valid)
_COMMON = ("cb_oct", "ord_oct", "inst_f", "inst_rows", "aux", "origmap",
           "sort_lo", "sort_scale", "root_lo", "root_hi")
VWALK_TABLES = _COMMON + ("vinst", "vglob")
IWALK_TABLES = _COMMON + ("inst_c",)
# iwalk's port-only object tables (`pack_object_boxes`; `upload` adds them),
# in the kernels' argument order
IWALK_BOXES = ("inst_p", "part_c", "ocb", "opb")
PART_W = 32  # object chunks per part: the kernels' chunk mask is one 32-bit word
NSTATS_IWALK = 9  # iwalk's counters before its per-instance flags


# --- host packing (NumPy) ---


def _model_chunk_tables(tri_sub: dict, normals9, pos, model_id: int, tri_off: int):
    """One model's chunk tables in partition-DFS layout: ``aux``
    [k*CH_W, AUX_COLS] OBJECT-space plane and shading rows, ``orig``
    [k*CH_W] global tri index, ``k``, and the per-chunk OBJECT boxes
    ``(cmin, cmax)`` [k, 3]."""
    bmin = pos.min(axis=1)
    bmax = pos.max(axis=1)
    perm, starts, spans = chunk_partition(bmin, bmax, CH_W)
    k = len(starts)
    cmin = np.minimum.reduceat(bmin[perm], starts, axis=0)
    cmax = np.maximum.reduceat(bmax[perm], starts, axis=0)
    S = k * CH_W
    slots = np.full(S, -1, np.int64)
    spans_a = np.asarray(spans)
    within = _ragged_arange(spans_a)
    rows = np.repeat(np.arange(k, dtype=np.int64) * CH_W, spans_a) + within
    slots[rows] = perm[np.repeat(np.asarray(starts), spans_a) + within]
    valid = slots >= 0
    idx = slots[valid]

    def fld(name):
        return np.asarray(tri_sub[name], np.float32)

    aux = np.zeros((S, AUX_COLS), np.float32)
    a = aux[valid]
    a[:, 0:3] = fld("n0")[idx]
    a[:, 3] = fld("d0")[idx]
    a[:, 4:7] = fld("n1")[idx]
    a[:, 7] = fld("d1")[idx]
    a[:, 8:11] = fld("n2")[idx]
    a[:, 11] = fld("d2")[idx]
    a[:, 12:21] = np.asarray(normals9, np.float32)[idx]
    a[:, 21] = float(model_id)
    aux[valid] = a
    orig = np.where(valid, tri_off + np.maximum(slots, 0), 0).astype(np.int32)
    return aux, orig, k, cmin, cmax


def _aabb_corners_world(bb_min, bb_max, matrix):
    """Conservative world box: all 8 corners through the rigid transform
    (fixes the reference's 2-corner transform, boundingbox.rs:51-57)."""
    rot, tr = matrix[:, :3], matrix[:, 3]
    pts = np.array(
        [[x, y, z]
         for x in (bb_min[0], bb_max[0])
         for y in (bb_min[1], bb_max[1])
         for z in (bb_min[2], bb_max[2])], np.float32,
    )
    world = pts @ rot.T + tr
    return world.min(axis=0), world.max(axis=0)


def _inst_orders(ibmin, ibmax, n_inst):
    """Per-octant front-to-back instance orders + permuted padded boxes.
    Instances with degenerate boxes (ibmin > ibmax: no chunks) sort to the
    back with 2e30 gate boxes."""
    live = (ibmin <= ibmax).all(axis=1)
    live_ids = np.flatnonzero(live)
    dead_ids = np.flatnonzero(~live)
    if len(live_ids) > 1:
        nodes, perm2, root = build_sah_tree(ibmin[live_ids], ibmax[live_ids], max_leaf=1)
        orders_local = perm2[_octant_orders(nodes, root, len(live_ids))]
        orders = live_ids[orders_local]
    else:
        orders = np.broadcast_to(live_ids, (8, len(live_ids))).copy()
    kq = ((n_inst + 127) // 128) * 128
    cb_oct = np.full((8, 6, kq), 2.0e30, np.float32)
    ord_pad = np.zeros((8, kq), np.int32)
    nl = len(live_ids)
    for o in range(8):
        po = orders[o] if nl else np.zeros(0, np.int64)
        cb_oct[o, 0:3, :nl] = ibmin[po].T
        cb_oct[o, 3:6, :nl] = ibmax[po].T
        ord_pad[o, :nl] = po
        ord_pad[o, nl : nl + len(dead_ids)] = dead_ids  # gated out (2e30 box)
    return cb_oct, ord_pad


def model_tables(models) -> dict:
    """What both engines share (host numpy): ``aux``/``origmap`` of every
    model's chunks in global object-slot order, ``chunk_off`` [M+1] each
    model's chunk range, the object chunk boxes ``cbox_min``/``cbox_max``
    [K, 3], and the instance list: ``inst_f`` [I, 12] (inverse rotation
    rows, inverse translation), ``inst_rows`` [I, 24] (inverse, forward
    rotation, model id), ``inst_mats`` (the [3, 4] matrices) and
    ``inst_mid`` (model ids); ``num_tris`` the object triangles."""
    aux_parts, orig_parts, cbox_min, cbox_max = [], [], [], []
    chunk_off = [0]
    tri_off = 0
    for mid, model in enumerate(models):
        pos = np.asarray(model.positions, np.float32)
        pre = tri_mod.precompute(pos)
        aux, orig, k, cmin, cmax = _model_chunk_tables(
            pre, np.asarray(model.normals, np.float32).reshape(-1, 9), pos, mid, tri_off,
        )
        aux_parts.append(aux)
        orig_parts.append(orig)
        chunk_off.append(chunk_off[-1] + k)
        cbox_min.append(cmin)
        cbox_max.append(cmax)
        tri_off += pos.shape[0]

    inst_f, inst_rows, inst_mats, inst_mid = [], [], [], []
    for mid, model in enumerate(models):
        for matrix in model.matrices:
            m = np.asarray(matrix, np.float32)
            rot, tr = m[:, :3], m[:, 3]
            rinv = rot.T
            tinv = -rinv @ tr
            inst_f.append(np.concatenate([rinv.reshape(9), tinv]))
            row = np.zeros(24, np.float32)
            row[0:9] = rinv.reshape(9)
            row[9:12] = tinv
            row[12:21] = rot.reshape(9)  # forward rotation (normals)
            row[21] = float(mid)
            inst_rows.append(row)
            inst_mats.append(m)
            inst_mid.append(mid)
    return {
        "aux": np.concatenate(aux_parts),
        "origmap": np.concatenate(orig_parts),
        "chunk_off": np.asarray(chunk_off, np.int64),
        "cbox_min": np.concatenate(cbox_min),
        "cbox_max": np.concatenate(cbox_max),
        "inst_f": np.stack(inst_f).astype(np.float32),
        "inst_rows": np.stack(inst_rows),
        "inst_mats": inst_mats,
        "inst_mid": inst_mid,
        "num_tris": tri_off,
    }


def num_virtual_chunks(shared: dict) -> int:
    """vwalk's gate entries: the (instance, object chunk) pairs."""
    per_model = np.diff(shared["chunk_off"])
    return int(sum(per_model[mid] for mid in shared["inst_mid"]))


def _scene_box(lo, hi):
    """Sort quantizers and the exit-clamp root box from world boxes."""
    scene_lo = lo.min(axis=0)
    scene_hi = hi.max(axis=0)
    extent = np.maximum(scene_hi - scene_lo, 1e-6)
    pad = 1e-4 * float(max(np.abs(scene_lo).max(), np.abs(scene_hi).max(), 1.0)) + 1e-6
    return {
        "sort_lo": scene_lo.astype(np.float32),
        "sort_scale": (1.0 / extent).astype(np.float32),
        "root_lo": (scene_lo - pad).astype(np.float32),
        "root_hi": (scene_hi + pad).astype(np.float32),
    }


def pack_iwalk(models, shared: dict | None = None) -> dict:
    """Pack the instanced-walk engine (host numpy; ``shared`` is
    `model_tables` of ``models`` when the caller has it). Gate entries are
    instances: ``cb_oct`` [8, 6, kq] world boxes in each octant's order,
    ``ord_oct`` [8, kq] instance ids, ``inst_c`` [I, 2] i32 each instance's
    object chunk range; plus ``inst_f``, ``inst_rows``, ``aux``,
    ``origmap`` and the scene box (`_scene_box`): the JAX package's tables.
    `upload` adds the port's object tables (`pack_object_boxes`)."""
    s = model_tables(models) if shared is None else shared
    chunk_off = s["chunk_off"]
    K = int(chunk_off[-1])
    if K > IWALK_MAX_TOTAL_CHUNKS:
        raise ValueError(f"iwalk caps at {IWALK_MAX_TOTAL_CHUNKS} model chunks, got {K}")
    n_inst = len(s["inst_mid"])
    inst_range = np.asarray([(chunk_off[m], chunk_off[m + 1]) for m in s["inst_mid"]], np.int64)
    # whole-instance world boxes; instances without chunks get inverted ones
    lo = np.full((n_inst, 3), 1.0, np.float32)
    hi = np.full((n_inst, 3), -1.0, np.float32)
    for i in range(n_inst):
        c0, c1 = inst_range[i]
        if c0 >= c1:
            continue
        olo = s["cbox_min"][c0:c1].min(axis=0)
        ohi = s["cbox_max"][c0:c1].max(axis=0)
        lo[i], hi[i] = _aabb_corners_world(olo, ohi, s["inst_mats"][i])
    cb_oct, ord_pad = _inst_orders(lo, hi, n_inst)
    empty = inst_range[:, 0] >= inst_range[:, 1]
    inst_c = np.stack(
        [np.where(empty, 0, inst_range[:, 0]), np.where(empty, 0, inst_range[:, 1])], axis=1,
    ).astype(np.int32)
    return {
        "cb_oct": cb_oct, "ord_oct": ord_pad, "inst_f": s["inst_f"], "inst_c": inst_c,
        "inst_rows": s["inst_rows"], "aux": s["aux"], "origmap": s["origmap"],
        **_scene_box(lo, hi),
    }


def pack_vwalk(models, shared: dict | None = None) -> dict:
    """Pack the virtual-chunk engine (host numpy; ``shared`` as for
    `pack_iwalk`). Gate entries are the virtual chunks: ``cb_oct``
    [8, 6, kvq] / ``ord_oct`` [8, kvq] as in ``walk.pack_walk`` but over the
    virtual-chunk world boxes; ``vinst`` / ``vglob`` [kvq] i32 the instance
    and the global object chunk of each layout slot; plus ``inst_f``,
    ``inst_rows``, ``aux``, ``origmap`` and the scene box."""
    s = model_tables(models) if shared is None else shared
    chunk_off, cbox_min, cbox_max = s["chunk_off"], s["cbox_min"], s["cbox_max"]
    # world boxes of every (instance, object chunk) pair: all 8 corners
    # through the rigid transform (boundingbox.rs:51-57 fix)
    v_inst, v_chunk, vb_lo, vb_hi = [], [], [], []
    for i, mid in enumerate(s["inst_mid"]):
        c0, c1 = chunk_off[mid], chunk_off[mid + 1]
        rot, tr = s["inst_mats"][i][:, :3], s["inst_mats"][i][:, 3]
        lo, hi = cbox_min[c0:c1], cbox_max[c0:c1]
        corners = np.stack(
            [np.stack([hi[:, 0] if j & 4 else lo[:, 0],
                       hi[:, 1] if j & 2 else lo[:, 1],
                       hi[:, 2] if j & 1 else lo[:, 2]], axis=1)
             for j in range(8)], axis=1)  # [k, 8, 3]
        world = corners @ rot.T + tr
        vb_lo.append(world.min(axis=1).astype(np.float32))
        vb_hi.append(world.max(axis=1).astype(np.float32))
        v_inst.append(np.full(c1 - c0, i, np.int32))
        v_chunk.append(np.arange(c0, c1, dtype=np.int32))
    v_inst = np.concatenate(v_inst)
    v_chunk = np.concatenate(v_chunk)
    vb_lo = np.concatenate(vb_lo)
    vb_hi = np.concatenate(vb_hi)
    kv = v_inst.shape[0]
    if kv > VWALK_MAX_VCH:
        raise ValueError(f"vwalk caps at {VWALK_MAX_VCH} virtual chunks, got {kv}")

    if kv > 1:
        nodes, perm2, root = build_sah_tree(vb_lo, vb_hi, max_leaf=1)
        ords = _octant_orders(nodes, root, kv)
    else:
        perm2 = np.zeros(1, np.int64)
        ords = np.zeros((8, 1), np.int32)
    lay = np.arange(kv, dtype=np.int64)[perm2]  # global virtual id per slot
    kvq = ((kv + 127) // 128) * 128
    cb_lo, cb_hi = vb_lo[lay], vb_hi[lay]
    cb_oct = np.full((8, 6, kvq), 2.0e30, np.float32)
    ord_pad = np.zeros((8, kvq), np.int32)
    for o in range(8):
        po = ords[o]
        cb_oct[o, 0:3, :kv] = cb_lo[po].T
        cb_oct[o, 3:6, :kv] = cb_hi[po].T
        ord_pad[o, :kv] = po
    vi = np.zeros(kvq, np.int32)
    vg = np.zeros(kvq, np.int32)
    vi[:kv] = v_inst[lay]
    vg[:kv] = v_chunk[lay]
    return {
        "cb_oct": cb_oct, "ord_oct": ord_pad, "vinst": vi, "vglob": vg,
        "inst_f": s["inst_f"], "inst_rows": s["inst_rows"], "aux": s["aux"],
        "origmap": s["origmap"], **_scene_box(vb_lo, vb_hi),
    }


def lane_slack(tables: dict) -> float:
    """The widening of the two-level world gate boxes (vwalk's virtual
    chunks, iwalk's instances) for the lanes' segment tests. Such a box
    holds the 8 float32-transformed corners of an unpadded object box (a
    chunk's, or a model's), while the pair test that must not be lost
    runs on the object-space ray: its rounding scales with object
    coordinates, the box's with world ones. Bound both: world coordinates by
    the root box W, object ones by sqrt(3) W plus the largest inverse
    translation T (rigid transforms keep lengths); the slack is the walk's
    chunk pad (1e-4 of the largest coordinate plus 1e-6) of the larger.

    What it covers. Let the pair test on q = G(r) (G the float32 inverse
    transform, as ``_obj_rays`` rounds it) accept a triangle of object
    chunk C at t in (EPSILON, t_limit), and X = r.o + t r.d. Per
    coordinate, with u = 2**-24: G(X) lies within d1 of C, d1 = the pair
    test's acceptance rounding (a few u of |q.o| + t) + the rounding of
    q.o (4u (|r.o| + T): three products, three sums) + t times that of q.d
    (3u). Mapping back by the forward transform F adds F(G(X)) - X (F, G
    float32 inverses: ~2u (|X| + |translation|)), each world box corner
    its own rounding (4u (|corner| + |translation|)), and the world slab
    test its own (3u |box - r.o|). Every term is at most about 20u S, S =
    |r.o| + t + sqrt(3) W + T, so a lane is kept whenever 1.2e-6 S <= slack,
    i.e. for rays whose origin lies within about 80 (sqrt(3) W + T) of the
    world origin: every ray the integrator casts starts on a scene surface
    or at the camera. The baked walk's padded chunk boxes make the same
    assumption about the origin's scale."""
    w = float(max(np.abs(tables["root_lo"]).max(), np.abs(tables["root_hi"]).max(), 1.0))
    t_inv = float(np.linalg.norm(np.asarray(tables["inst_f"])[:, 9:12], axis=1).max(initial=0.0))
    return 1e-4 * (3.0 ** 0.5 * w + t_inv) + 1e-6


def _plane_vertices(planes):
    """The vertices ``[T, 3, 3]`` (float64) of the triangles that the plane
    rows ``planes [T, 12]`` (n0 d0 n1 d1 n2 d2) describe: the points where
    n0.x = d0 and (u, v) = (n1.x + d1, n2.x + d2) is (0, 0), (1, 0) and
    (0, 1), solved exactly up to float64 rounding (Cramer's rule), so they
    are the corners of the triangle the pair tests see; NaN or inf where
    the rows are singular."""
    p = planes.astype(np.float64)
    r0, r1, r2 = p[:, 0:3], p[:, 4:7], p[:, 8:11]
    c0, c1, c2 = np.cross(r1, r2), np.cross(r2, r0), np.cross(r0, r1)
    det = (r0 * c0).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        base = (p[:, 3:4] * c0 - p[:, 7:8] * c1 - p[:, 11:12] * c2) / det[:, None]
        return np.stack([base, base + c1 / det[:, None], base + c2 / det[:, None]], axis=1)


def pack_object_boxes(aux, inst_c) -> dict:
    """iwalk's object-space cull tables, from the shared plane rows ``aux``
    [K*CH_W, AUX_COLS] and the instances' chunk ranges ``inst_c`` [I, 2]
    (host numpy): ``ocb`` [K, 6] f32 each object chunk's box (lo xyz | hi
    xyz); ``opb`` [P, 6] f32 the boxes of the parts, runs of at most
    `PART_W` chunks of one model (a chunk's model is its first row's id,
    ``aux`` column 21), ``part_c`` [P, 2] i32 each part's chunk range and
    ``inst_p`` [I, 2] i32 each instance's part range.

    A chunk's box holds the vertices of its rows' triangles as the pair
    tests see them (`_plane_vertices`), padded by 1e-4 of the model's
    largest coordinate plus 1e-6, as ``walk.pack_walk`` pads its chunk
    boxes: the lanes' object-space segment test then keeps every triangle
    the pair test can hit, within its rounding. A row with n0 = 0 (a pad
    row, or a degenerate triangle) has det = 0 for every ray and never hits,
    so it adds nothing; a real row whose vertices cannot be solved makes its
    chunk's box the whole space; a chunk of no hittable row gets an
    inverted box, never entered. Built from the tables the kernels read,
    so `from_jax_scene` rebuilds the same bits."""
    aux = np.asarray(aux, np.float32)
    k = aux.shape[0] // CH_W
    planes = aux[:, :12]
    live = (planes[:, 0:3] != 0.0).any(axis=1)
    v = _plane_vertices(planes[live])  # [L, 3, 3]
    ok = np.isfinite(v).all(axis=(1, 2))
    chunk = np.flatnonzero(live) // CH_W
    model = aux[::CH_W, 21].astype(np.int64)  # [k]: each chunk's first row is real
    vmax = np.abs(np.where(ok[:, None, None], v, 0.0)).max(axis=(1, 2))
    big = np.zeros(int(model.max(initial=0)) + 1)
    np.maximum.at(big, model[chunk], vmax)
    pad = 1e-4 * np.maximum(big, 1.0) + 1e-6
    lo = np.full((k, 3), np.inf)
    hi = np.full((k, 3), -np.inf)
    np.minimum.at(lo, chunk[ok], v[ok].min(axis=1))
    np.maximum.at(hi, chunk[ok], v[ok].max(axis=1))
    whole = np.zeros(k, bool)
    whole[chunk[~ok]] = True
    lo[whole], hi[whole] = -np.inf, np.inf
    empty = ~np.isfinite(lo).all(axis=1) & ~whole
    ocb = np.concatenate([lo - pad[model][:, None], hi + pad[model][:, None]], axis=1)
    ocb[empty] = [_BIG] * 3 + [-_BIG] * 3
    ocb = ocb.astype(np.float32)
    # parts: runs of PART_W chunks within each model's contiguous range
    first = np.flatnonzero(np.diff(model, prepend=-1))
    part_c = np.array([(a, min(a + PART_W, b))
                       for m0, b in zip(first, np.append(first[1:], k))
                       for a in range(m0, b, PART_W)], np.int64).reshape(-1, 2)
    starts = part_c[:, 0]
    opb = np.empty((starts.size, 6), np.float32)
    for i, (a, b) in enumerate(part_c):
        opb[i, 0:3] = ocb[a:b, 0:3].min(axis=0)
        opb[i, 3:6] = ocb[a:b, 3:6].max(axis=0)
    inst_c = np.asarray(inst_c, np.int64)
    inst_p = np.stack([np.searchsorted(starts, inst_c[:, 0]),
                       np.searchsorted(starts, inst_c[:, 1])], axis=1)
    inst_p[inst_c[:, 0] >= inst_c[:, 1]] = 0
    return {"ocb": ocb, "opb": opb, "part_c": part_c.astype(np.int32),
            "inst_p": inst_p.astype(np.int32)}


def upload(tables: dict, device) -> dict:
    """An engine's tables as tensors on ``device``, plus ``gates`` (an int:
    the gate entries, the columns of ``cb_oct`` that are not 2e30 pads),
    ``lane_slack`` (`lane_slack`, a 0-dim float32 tensor kept on the CPU:
    the kernels take it by value) and, for iwalk, its object tables
    (`pack_object_boxes`)."""
    if "inst_c" in tables:
        tables = {**tables, **pack_object_boxes(tables["aux"], tables["inst_c"])}
    eng = {k: torch.from_numpy(np.array(v, order="C")).to(device) for k, v in tables.items()}
    eng["gates"] = int((np.asarray(tables["cb_oct"])[0, 0] < 1e30).sum())
    eng["lane_slack"] = torch.tensor(lane_slack(tables), dtype=torch.float32)
    return eng


def engine_name(eng: dict) -> str:
    return "vwalk" if "vinst" in eng else "iwalk"


def table_bytes(eng: dict) -> int:
    """Bytes of an engine's tables."""
    return sum(v.numel() * v.element_size() for v in eng.values() if torch.is_tensor(v))


def _obj_rays(m, o, d):
    """Rays ``o, d [n, 3]`` through the inverse rigid transform ``m [..., 12]``
    (rotation rows m0..m8, translation m9..m11; one instance's, or one per
    ray), in the JAX ``_obj_rays`` order. Rigid, so t is unchanged."""
    r = [m[..., j] for j in range(12)]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    o2 = torch.stack([r[0] * ox + r[1] * oy + r[2] * oz + r[9],
                      r[3] * ox + r[4] * oy + r[5] * oz + r[10],
                      r[6] * ox + r[7] * oy + r[8] * oz + r[11]], dim=1)
    d2 = torch.stack([r[0] * dx + r[1] * dy + r[2] * dz,
                      r[3] * dx + r[4] * dy + r[5] * dz,
                      r[6] * dx + r[7] * dy + r[8] * dz], dim=1)
    return o2, d2


# --- kernel binding ---


def _lib():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return load("iwalk_hit", {
        "vwalk_closest": [i, p, p, p, p, p, p, i, i, f, p, p, p, i, p, p, p, p, p],
        "vwalk_any": [i, p, p, p, p, p, p, i, i, f, p, p, p, i, p, p, p],
        "iwalk_closest": [i, p, p, p, p, p, p, p, p, i, i, f, p, p, p, i, p, p, p, p, p],
        "iwalk_any": [i, p, p, p, p, p, p, p, p, i, i, f, p, p, p, i, p, p, p],
    })


def _index_tables(eng):
    """The engine's tables after ``ord_oct`` and before ``inst_f``, in the
    kernels' argument order."""
    return ("vinst", "vglob") if "vinst" in eng else IWALK_BOXES


def _check_cuda(eng, origin, direction, t_limit):
    dev = origin.device
    if "vinst" not in eng and "ocb" not in eng:
        raise ValueError("an iwalk table needs its object boxes (iwalk.upload adds them)")
    checks = [("aux", torch.float32), ("cb_oct", torch.float32), ("ord_oct", torch.int32),
              ("inst_f", torch.float32)] + [
        (k, torch.float32 if k in ("ocb", "opb") else torch.int32) for k in _index_tables(eng)]
    for name, x, dtype in [(k, eng[k], t) for k, t in checks] + [
        ("origin", origin, torch.float32), ("direction", direction, torch.float32),
        ("t_limit", t_limit, torch.float32),
    ]:
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != dev:
            raise ValueError("all tensors must be on one device")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}")
    aux, cb, od, inst_f = eng["aux"], eng["cb_oct"], eng["ord_oct"], eng["inst_f"]
    if aux.data_ptr() % 16:
        raise ValueError("aux must be 16-byte aligned (the kernels read it as float4)")
    if aux.dim() != 2 or aux.shape[1] != AUX_COLS or aux.shape[0] % CH_W:
        raise ValueError(f"aux must be [k*{CH_W}, {AUX_COLS}], got {tuple(aux.shape)}")
    kq, n_inst = od.shape[-1], inst_f.shape[0]
    if od.shape != (8, kq) or cb.shape != (8, 6, kq) or not 0 <= eng["gates"] <= kq:
        raise ValueError("ord_oct must be [8, kq] and cb_oct [8, 6, kq], kq >= gates")
    if inst_f.shape != (n_inst, 12):
        raise ValueError("inst_f must be [I, 12]")
    if "vinst" in eng:
        if eng["vinst"].shape != (kq,) or eng["vglob"].shape != (kq,):
            raise ValueError("vinst and vglob must be [kq]")
    else:
        n_parts = eng["opb"].shape[0]
        if (eng["ocb"].shape != (aux.shape[0] // CH_W, 6) or eng["opb"].shape != (n_parts, 6)
                or eng["part_c"].shape != (n_parts, 2) or eng["inst_p"].shape != (n_inst, 2)):
            raise ValueError("ocb must be [k, 6], opb [P, 6], part_c [P, 2] and inst_p [I, 2]")
        if eng["gates"] > n_inst:
            raise ValueError("gates must be <= I")
    n = origin.shape[0]
    if origin.shape != (n, 3) or direction.shape != (n, 3) or t_limit.shape != (n,):
        raise ValueError("origin/direction must be [N, 3] and t_limit [N]")


def num_stats(eng) -> int:
    """The length of a kernel's ``stats`` tensor: vwalk's six counters and
    a flag per virtual chunk (by layout slot), or iwalk's nine
    (`NSTATS_IWALK`) and a flag per instance (by id)."""
    if "vinst" in eng:
        return NSTATS + eng["gates"]
    return NSTATS_IWALK + eng["inst_f"].shape[0]


def _check_stats(eng, origin, stats):
    if stats is not None and (stats.device != origin.device or stats.dtype != torch.int64
                              or stats.shape != (num_stats(eng),)):
        raise ValueError(f"stats must be an int64 [{num_stats(eng)}] tensor on the rays' device")
    return None if stats is None else stats.data_ptr()


def _launch(eng, query, origin, direction, t_limit, outs, stats):
    """Launch the engine's ``query`` ("closest" or "any") kernel."""
    _check_cuda(eng, origin, direction, t_limit)
    stats_ptr = _check_stats(eng, origin, stats)
    key = f"{engine_name(eng)}_{query}"
    fn = getattr(_lib(), key)
    tables = [eng[k].data_ptr() for k in ("aux", "cb_oct", "ord_oct", *_index_tables(eng), "inst_f")]
    dev = origin.device
    LAUNCHES[key] += 1
    err = fn(dev.index, *tables, eng["gates"], eng["ord_oct"].shape[1], float(eng["lane_slack"]),
             origin.data_ptr(), direction.data_ptr(), t_limit.data_ptr(), origin.shape[0],
             *[x.data_ptr() for x in outs], stats_ptr, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{key} launch failed: cudaError {err}")


def closest_cuda(eng, origin, direction, t_limit, stats=None):
    """Kernel closest hit (vwalk or iwalk, by the engine) over rays in
    sorted order (raw origin/direction, exit-clamped t_limit). Returns
    ``(best_t [N] f32, slot [N] i32, inst [N] i32)``: the object-global
    slot (chunk * 128 + lane) and the instance of the winner, or
    (1e30, -1, -1) on a miss. ``stats``, a zeroed int64 CUDA tensor
    [`num_stats`], receives (blocks with a live lane, gate entries
    admitted, survivors skipped by the window, lanes listed on a staged
    chunk, staged chunks, (lane, real triangle) pairs tested), for iwalk
    then the (lane, instance), (lane, part) and (lane, chunk) box tests
    that entered, then a 1 for every virtual chunk staged (vwalk) or
    instance some lane entered (iwalk)."""
    n, dev = origin.shape[0], origin.device
    best_t = torch.empty(n, dtype=torch.float32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    inst = torch.empty(n, dtype=torch.int32, device=dev)
    _launch(eng, "closest", origin, direction, t_limit, (best_t, slot, inst), stats)
    return best_t, slot, inst


def any_cuda(eng, origin, direction, t_limit, stats=None):
    """Kernel shadow test (raw origin/direction, exit-clamped t_limit): bool
    ``[N]``, False on dead and non-finite lanes. ``stats`` as for
    `closest_cuda` (the listed lanes: those that entered a staged chunk and
    were not yet occluded)."""
    out = torch.empty(origin.shape[0], dtype=torch.bool, device=origin.device)
    _launch(eng, "any", origin, direction, t_limit, (out,), stats)
    return out


# --- plain torch versions (same expressions, same order, ungated) ---


def _columns(eng, device):
    """The plain versions' columns: for each instance with chunks, in
    instance order, its object chunks' slots. Returns the segments
    ``[(instance, first aux row, end aux row, first column)]``, and per
    column the object slot and the instance (int64 [S])."""
    if "inst_c" in eng:
        span = eng["inst_c"].to(device=device, dtype=torch.int64)
    else:  # each instance's chunk range, from its virtual chunks
        g = eng["gates"]
        vi = eng["vinst"][:g].to(device=device, dtype=torch.int64)
        vg = eng["vglob"][:g].to(device=device, dtype=torch.int64)
        n_inst = eng["inst_f"].shape[0]
        lo = torch.full((n_inst,), 1 << 62, dtype=torch.int64, device=device)
        hi = torch.zeros(n_inst, dtype=torch.int64, device=device)
        span = torch.stack([lo.scatter_reduce(0, vi, vg, "amin"),
                            hi.scatter_reduce(0, vi, vg + 1, "amax")], dim=1)
    segs, col = [], 0
    for i, (c0, c1) in enumerate(span.tolist()):
        if c1 > c0:
            segs.append((i, c0 * CH_W, c1 * CH_W, col))
            col += (c1 - c0) * CH_W
    slot = torch.cat([torch.arange(a, b, device=device) for _, a, b, _ in segs])
    inst = torch.cat([torch.full((b - a,), i, device=device) for i, a, b, _ in segs])
    return segs, slot, inst


def _rank_columns(eng, segs, col_slot, col_inst, device):
    """``[8, S]`` visit rank of every column in each octant's order: vwalk:
    position of its virtual chunk * CH_W + lane; iwalk: position of its
    instance * S + its column within the instance (chunk * CH_W + lane)."""
    n_inst, g = eng["inst_f"].shape[0], eng["gates"]
    if "inst_c" in eng:
        pos = _order_positions(eng["ord_oct"], g, n_inst, device)
        start = torch.zeros(n_inst, dtype=torch.int64, device=device)
        start[[i for i, *_ in segs]] = torch.tensor([c for *_, c in segs], device=device)
        within = torch.arange(col_slot.numel(), device=device) - start[col_inst]
        return pos[:, col_inst] * col_slot.numel() + within
    vcol = _column_vchunks(eng, segs, device)
    pos = _order_positions(eng["ord_oct"], g, g, device)
    j = torch.arange(col_slot.numel(), device=device)
    return pos[:, vcol[j // CH_W]] * CH_W + j % CH_W


def _column_vchunks(eng, segs, device):
    """vwalk: the virtual chunk (layout slot) of each column chunk of
    `_columns`: its instance's first column chunk plus its object chunk's
    offset in the instance's range (int64 [g])."""
    n_inst, g = eng["inst_f"].shape[0], eng["gates"]
    vi = eng["vinst"][:g].to(device=device, dtype=torch.int64)
    vg = eng["vglob"][:g].to(device=device, dtype=torch.int64)
    first_col = torch.zeros(n_inst, dtype=torch.int64, device=device)
    first_row = torch.zeros(n_inst, dtype=torch.int64, device=device)
    first_col[[i for i, *_ in segs]] = torch.tensor([c // CH_W for *_, c in segs], device=device)
    first_row[[i for i, *_ in segs]] = torch.tensor([a // CH_W for _, a, _, _ in segs], device=device)
    vcol = torch.empty(g, dtype=torch.int64, device=device)
    vcol[first_col[vi] + vg - first_row[vi]] = torch.arange(g, device=device)
    return vcol


def _plain_steps(eng, origin, direction, t_limit):
    """The plain versions' work list: the segments and column maps
    (`_columns`), the plane rows and inverse transforms in the rays' dtype,
    the live lanes' rows, and steps of (o, d, t_limit [n, 1], start) over
    the live lanes bounded by the pairs budget."""
    dev = origin.device
    o, d, tl = _lanes(origin, direction, t_limit)
    live = (tl > 0.0).nonzero()[:, 0]
    segs, col_slot, col_inst = _columns(eng, dev)
    planes = eng["aux"][:, :12].to(origin.dtype)
    inst_f = eng["inst_f"].to(origin.dtype)
    step = max(1, _PLAIN_PAIRS[dev.type] // max(col_slot.numel(), 1))
    o, d, tl = o[live], d[live], tl[live]
    steps = [(o[s : s + step], d[s : s + step], tl[s : s + step, None], s)
             for s in range(0, live.numel(), step)]
    return segs, col_slot, col_inst, planes, inst_f, live, steps


def closest_plain(eng, origin, direction, t_limit):
    """Plain version of `closest_cuda` (any device, any float dtype: run in
    float64 it is the precision oracle)."""
    n, dev = origin.shape[0], origin.device
    segs, col_slot, col_inst, planes, inst_f, live, steps = _plain_steps(
        eng, origin, direction, t_limit)
    oct_live = _block_octant(direction)[live]
    rank = _rank_columns(eng, segs, col_slot, col_inst, dev) if steps else None
    best_t = torch.full((n,), _BIG, dtype=origin.dtype, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for o, d, tl, s in steps:
        tm = torch.cat([_candidate_t(planes[a:b], *_obj_rays(inst_f[i], o, d), tl)
                        for i, a, b, _ in segs], dim=1)
        bt, first = _closest_columns(tm, rank, oct_live[s : s + o.shape[0]])
        rows = live[s : s + o.shape[0]]
        hit = bt < _BIG
        best_t[rows] = bt
        slot[rows] = torch.where(hit, col_slot[first], -1).to(torch.int32)
        inst[rows] = torch.where(hit, col_inst[first], -1).to(torch.int32)
    return best_t, slot, inst


def any_plain(eng, origin, direction, t_limit):
    """Plain version of `any_cuda`: an ungated OR over every (instance,
    object chunk) pair."""
    segs, _, _, planes, inst_f, live, steps = _plain_steps(eng, origin, direction, t_limit)
    out = torch.zeros(origin.shape[0], dtype=torch.bool, device=origin.device)
    for o, d, tl, s in steps:
        hit = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for i, a, b, _ in segs:
            hit |= _shadow_hits(planes[a:b], *_obj_rays(inst_f[i], o, d), tl).any(dim=1)
        out[live[s : s + o.shape[0]]] = hit
    return out


# --- the kernels' per-lane cull, as a plain model (tests, chip_smoke.py) ---


def virtual_boxes(eng):
    """vwalk's gate boxes widened by its ``lane_slack`` in layout order:
    ``(lo, hi)`` [g, 3], the box of layout slot v at row v."""
    g = eng["gates"]
    cols = eng["ord_oct"][0, :g].long()
    lo = torch.empty((g, 3), dtype=eng["cb_oct"].dtype, device=cols.device)
    hi = torch.empty_like(lo)
    slack = float(eng["lane_slack"])  # float32-exact
    lo[cols] = eng["cb_oct"][0, 0:3, :g].T - slack
    hi[cols] = eng["cb_oct"][0, 3:6, :g].T + slack
    return lo, hi


def instance_boxes(eng):
    """iwalk's gate boxes widened by its ``lane_slack``, by instance id:
    ``(lo, hi)`` [I, 3]; an instance that is no gate entry (no chunks) gets
    an inverted box."""
    g, n_inst = eng["gates"], eng["inst_f"].shape[0]
    ids = eng["ord_oct"][0, :g].long()
    lo = torch.full((n_inst, 3), _BIG, dtype=eng["cb_oct"].dtype, device=ids.device)
    hi = torch.full_like(lo, -_BIG)
    slack = float(eng["lane_slack"])
    lo[ids] = eng["cb_oct"][0, 0:3, :g].T - slack
    hi[ids] = eng["cb_oct"][0, 3:6, :g].T + slack
    return lo, hi


def to_world(eng, inst, o, d):
    """Object-space rays ``o, d [n, 3]`` through the forward rigid transform
    of instances ``inst [n]`` (``inst_rows``' forward rotation R, columns
    12-20, and its inverse translation -R^T t, columns 9-11, turned back
    to t), in float64 rounded once to float32: world rays that meet the
    same object points at the same t, up to that rounding (tests,
    chip_smoke.py)."""
    rows = eng["inst_rows"].double()[inst.long()]
    rot = rows[:, 12:21].view(-1, 3, 3)
    tr = -(rot @ rows[:, 9:12, None])[:, :, 0]
    return (((rot @ o.double()[:, :, None])[:, :, 0] + tr).float().contiguous(),
            (rot @ d.double()[:, :, None])[:, :, 0].float().contiguous())


def entry_hits(eng, o, d, tl):
    """``[n, E]``: whether each lane (lane values ``o, d``, ``tl [n]``) has
    a hit in (EPSILON, t_limit) in each cull entry, on its object-space ray,
    by the any-hit kernels' sign tests. vwalk's entries are its virtual
    chunks (layout slots); iwalk's the (instance, object chunk) pairs of
    `_columns`, instance by instance."""
    planes = eng["aux"][:, :12].to(o.dtype)
    inst_f = eng["inst_f"].to(o.dtype)
    if "inst_c" in eng:
        segs, _, _ = _columns(eng, o.device)
        return torch.cat([_shadow_hits(planes[a:b], *_obj_rays(inst_f[i], o, d), tl[:, None])
                          .view(o.shape[0], -1, CH_W).any(dim=2) for i, a, b, _ in segs], dim=1)
    g = eng["gates"]
    vi = eng["vinst"][:g].to(device=o.device, dtype=torch.int64)
    vg = eng["vglob"][:g].to(device=o.device, dtype=torch.int64)
    hits = torch.zeros((o.shape[0], g), dtype=torch.bool, device=o.device)
    for i in torch.unique(vi).tolist():
        cols = (vi == i).nonzero()[:, 0]
        oo, dd = _obj_rays(inst_f[i], o, d)
        per_chunk = _shadow_hits(planes, oo, dd, tl[:, None]).view(o.shape[0], -1, CH_W).any(dim=2)
        hits[:, cols] = per_chunk[:, vg[cols]]
    return hits


def entry_enters(eng, o, d, tw):
    """``[n, E]`` (the entries of `entry_hits`): whether each lane passes
    the kernel's cull of each entry within its window ``tw [n]``, each level
    by ``walk.lane_enters``. vwalk: the virtual chunk's widened world box.
    iwalk: the instance's widened world box (`instance_boxes`) on the world
    ray, then on the object-space ray (`_obj_rays`, the kernels' obj_ray)
    the box of the part that holds the chunk (``opb``) and the chunk's own
    box (``ocb``)."""
    if "vinst" in eng:
        return lane_enters(*virtual_boxes(eng), o, d, tw)
    ilo, ihi = instance_boxes(eng)
    inst_f = eng["inst_f"].to(o.dtype)
    ocb, opb = eng["ocb"].to(o.dtype), eng["opb"].to(o.dtype)
    starts = eng["part_c"][:, 0].to(device=o.device, dtype=torch.int64)
    segs = _columns(eng, o.device)[0]
    out = torch.zeros((o.shape[0], sum(b - a for _, a, b, _ in segs) // CH_W), dtype=torch.bool,
                      device=o.device)
    for i, a, b, col in segs:
        c = torch.arange(a // CH_W, b // CH_W, device=o.device)
        part = torch.searchsorted(starts, c, right=True) - 1
        r = lane_enters(ilo[i : i + 1], ihi[i : i + 1], o, d, tw)[:, 0].nonzero()[:, 0]
        oo, dd = _obj_rays(inst_f[i], o[r], d[r])  # elementwise: the same bits on a row subset
        p = lane_enters(opb[part, 0:3], opb[part, 3:6], oo, dd, tw[r])
        out[r, col // CH_W : col // CH_W + c.numel()] = p & lane_enters(
            ocb[c, 0:3], ocb[c, 3:6], oo, dd, tw[r])
    return out


def _column_entries(eng, segs, device):
    """The cull entry (of `entry_enters`) of each column chunk of
    `_columns`: vwalk's virtual chunk (`_column_vchunks`); iwalk's column
    chunks are its entries, in order."""
    if "inst_c" in eng:
        return torch.arange(sum(b - a for _, a, b, _ in segs) // CH_W, device=device)
    return _column_vchunks(eng, segs, device)


def culled_closest_plain(eng, origin, direction, t_limit):
    """The closest hit through the kernel's per-lane cull at its tightest: a
    lane tests the object chunk of an (instance, chunk) column only if it
    passes `entry_enters` within ``min(t*, t_limit)``, t* the lane's plain
    closest t (the least window a kernel lane can reach). Equal to
    `closest_plain` when the cull is exact."""
    n, dev = origin.shape[0], origin.device
    t_star, _, _ = closest_plain(eng, origin, direction, t_limit)
    segs, col_slot, col_inst, planes, inst_f, live, steps = _plain_steps(
        eng, origin, direction, t_limit)
    oct_live = _block_octant(direction)[live]
    rank = _rank_columns(eng, segs, col_slot, col_inst, dev) if steps else None
    ent = _column_entries(eng, segs, dev)
    best_t = torch.full((n,), _BIG, dtype=origin.dtype, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for o, d, tl, s in steps:
        rows = live[s : s + o.shape[0]]
        enter = entry_enters(eng, o, d, torch.minimum(t_star[rows], tl[:, 0]))
        tm = torch.cat([_candidate_t(planes[a:b], *_obj_rays(inst_f[i], o, d), tl)
                        for i, a, b, _ in segs], dim=1)
        tm = torch.where(enter[:, ent].repeat_interleave(CH_W, dim=1), tm, _BIG)
        bt, first = _closest_columns(tm, rank, oct_live[s : s + o.shape[0]])
        hit = bt < _BIG
        best_t[rows] = bt
        slot[rows] = torch.where(hit, col_slot[first], -1).to(torch.int32)
        inst[rows] = torch.where(hit, col_inst[first], -1).to(torch.int32)
    return best_t, slot, inst


def culled_any_plain(eng, origin, direction, t_limit):
    """The any hit through the kernel's per-lane cull: a lane tests an
    entry's object chunk only if it passes `entry_enters` within its
    t_limit. Equal to `any_plain` when the cull is exact."""
    o, d, tl = _lanes(origin, direction, t_limit)
    live = (tl > 0.0).nonzero()[:, 0]
    out = torch.zeros(origin.shape[0], dtype=torch.bool, device=origin.device)
    if live.numel():
        o, d, tl = o[live], d[live], tl[live]
        out[live] = (entry_hits(eng, o, d, tl) & entry_enters(eng, o, d, tl)).any(dim=1)
    return out


def tie_tables(positions, index: int, matrix):
    """`pack_iwalk` tables of two coincident instances (``matrix`` [3, 4])
    of the soup ``positions`` with triangle ``index`` also copied into the
    first two pad slots of another object chunk B (tests, chip_smoke.py):
    one triangle in two instances, in two chunks of each and twice within
    one. B is the first chunk with two pad slots (the one before the
    triangle's own chunk A if there is one); `upload` builds the object
    boxes from the rows, so B's box grows to hold the copies. Returns
    (tables, the three object slots that hold the triangle)."""
    from path_tracer_tpu_torch.scene.model import Model

    pos = np.asarray(positions, np.float32)
    tables = pack_iwalk([Model(None, matrices=[matrix, matrix], positions=pos)])
    aux = tables["aux"]
    k = aux.shape[0] // CH_W
    real = (aux[:, :12] != 0).any(axis=1).reshape(k, CH_W)
    src = int(np.flatnonzero((tables["origmap"] == index) & real.reshape(-1))[0])
    cand = np.flatnonzero(real.sum(axis=1) <= CH_W - 2)
    cand = cand[cand != src // CH_W]
    b = int(cand[0])
    dst = [b * CH_W + int(real[b].sum()) + i for i in range(2)]
    aux[dst] = aux[src]
    tables["origmap"][dst] = tables["origmap"][src]
    return tables, (src, *dst)


# --- public queries (the JAX iwalk_* contracts) ---


def iwalk_closest_hit_shade(eng: dict, origin, direction, t_limit):
    """Closest hit through instances: ``(tri_idx i32, t, u, v, normal_world
    [N,3], model i32, inst i32)`` — tri_idx in the engine's global
    object-tri order, -1 on a miss (t = t_limit, u = v = 0, zero normal and
    model, inst -1). The normal is the object-space barycentric
    interpolation rotated to world, unnormalised."""
    o, d, tl = _f32(origin, direction, t_limit)
    order, o_s, d_s, tl_s = _sorted_rays(eng, o, d, tl)
    run = closest_plain if o.device.type == "cpu" else closest_cuda
    _, slot, inst = run(eng, o_s, d_s, tl_s)
    slot = _unsort_rows(slot, order)
    inst = _unsort_rows(inst, order)
    hit = slot >= 0
    # the winner's object-space ray, in the kernels' transform order
    irow = eng["inst_rows"].index_select(0, inst.clamp(min=0))
    out = _epilogue(eng["aux"], slot, *_obj_rays(irow, o, d))
    nx, ny, nz = out[:, 4], out[:, 5], out[:, 6]
    # deferred normal transform: world n = forward rotation @ object n
    normal = torch.stack([irow[:, 12] * nx + irow[:, 13] * ny + irow[:, 14] * nz,
                          irow[:, 15] * nx + irow[:, 16] * ny + irow[:, 17] * nz,
                          irow[:, 18] * nx + irow[:, 19] * ny + irow[:, 20] * nz], dim=1)
    t = torch.where(hit, out[:, 0], tl)
    u = torch.where(hit, out[:, 2], 0.0)
    v = torch.where(hit, out[:, 3], 0.0)
    normal = torch.where(hit[:, None], normal, 0.0)
    orig = torch.where(hit, eng["origmap"].index_select(0, slot.clamp(min=0)), -1)
    return orig, t, u, v, normal, out[:, 7].to(torch.int32), torch.where(hit, inst, -1)


def iwalk_any_hit(eng: dict, origin, direction, t_limit) -> torch.Tensor:
    """True where a hit with EPSILON < t < t_limit exists (unsorted rays)."""
    o, d, tl = _f32(origin, direction, t_limit)
    tl = _exit_clamp(eng, o, d, tl).contiguous()
    if o.device.type == "cpu":
        return any_plain(eng, o, d, tl)
    return any_cuda(eng, o, d, tl)


def iwalk_stats(eng: dict, origin, direction, t_limit, query: str = "closest") -> dict:
    """Cull economics of one ``query`` ("closest" or "any") on the card, with
    the public query's ray order: ``blocks`` (with a live lane), ``visits``
    (gate entries a block admitted: virtual chunks or instances),
    ``skipped`` (gated survivors the live window skipped), ``lane_visits``
    (lanes listed on a staged chunk: those whose own segment test entered
    it, and for the any hit that were not yet occluded), ``staged`` (chunks
    staged), ``pairs`` (the (lane, real triangle) pair tests), summed over
    blocks, ``entries`` (distinct gate entries: vwalk's virtual chunks
    staged, iwalk's instances some lane entered) and ``lanes`` (the valid
    lanes); iwalk adds ``instances``, ``parts`` and ``chunks``, the (lane,
    box) tests that entered at each level. CUDA tensors only."""
    o, d, tl = _f32(origin, direction, t_limit)
    stats = torch.zeros(num_stats(eng), dtype=torch.int64, device=o.device)
    if query == "closest":
        _, o, d, tl = _sorted_rays(eng, o, d, tl)
        closest_cuda(eng, o, d, tl, stats=stats)
    else:
        tl = _exit_clamp(eng, o, d, tl).contiguous()
        any_cuda(eng, o, d, tl, stats=stats)
    c = stats.cpu().tolist()
    out = {"blocks": c[0], "visits": c[1], "skipped": c[2], "lane_visits": c[3], "staged": c[4],
           "pairs": c[5], "lanes": int(_valid(o, d, tl).sum())}
    if "vinst" in eng:
        out["entries"] = sum(c[NSTATS:])
    else:
        out.update(instances=c[6], parts=c[7], chunks=c[8], entries=sum(c[NSTATS_IWALK:]))
    return out
