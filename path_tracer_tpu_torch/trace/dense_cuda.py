"""Dense closest-hit / any-hit over one <=16K-triangle table: the CUDA
kernels of ``csrc/dense_hit.cu``, their plain torch versions, the plain
model of the kernels' cull, and the table packing.

Port of ``path_tracer_tpu/trace/dense_pallas.py`` (``_closest_kernel`` and
``_any_kernel``, reached through ``dense_pl_closest_hit_shade`` and
``dense_pl_any_hit``). Precision is ``intersect_naive`` Havel-Herout (no
ray pre-translation), EPSILON < t < t_limit, lowest table index on ties.

A dense table is ``{"aux": [T, 24] rows, "cab": [ceil(T/CH), 6] chunk
boxes}`` (`pack_dense_aux`, `pack_dense_cab`); the kernels test a ray only
against the rows of the chunks whose box its own segment enters, and a
table without ``cab`` raises. The plain versions (`closest_plain`,
`any_plain`) test every row: they are what the kernels are held to.
`culled_closest_plain` and `culled_any_plain` are the cull as a plain model
(tests and ``chip_smoke.py``).

Each query has one wrapper. On a CPU tensor it runs the plain version; on a
CUDA tensor it launches the kernel, or raises. ``LAUNCHES`` (shared with the
walk kernels, `trace.cuda_lib`) counts kernel launches per kernel, so a run
can show that its queries went through them.

The kernels are built at first use by `trace.cuda_lib`. They are compiled
with ``-fmad=false`` and the plain versions evaluate the same expressions in
the same order, one rounding per op, so both give the same bits (see the
note at the top of ``dense_hit.cu``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from path_tracer_tpu_torch.core.constants import EPSILON
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES, load

DENSE_MAX_TRIS = 16384
CH = 128  # rows per chunk box (the walk's CH_W; csrc/dense_hit.cu CH)
NSTATS = 6  # the kernels' counters (`dense_stats`)
AUX_COLS = 24  # n0(3) d0 n1(3) d1 n2(3) d2 | na nb nc (9) | model | pad(2)
_BIG = 1e30  # "no winner" sentinel, as in dense_pallas
_T_CLAMP = 3.0e38  # finite stand-in for an infinite t_limit
# [rays, tris] pairs per step of the plain versions (bounds their memory)
_PLAIN_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 25}



# --- table packing (host, NumPy) ---


def pack_dense_aux(tri: dict, normals_flat=None, model=None) -> np.ndarray:
    """Row-major ``[T, 24]`` table, one row per triangle: plane data (12) +
    the three vertex shading normals (9) + model id (exact float) + pad (2).
    Its rows are the first T rows of dense_pallas's aux table (which pads
    to its chunk width; the kernels here need no padding).
    ``normals_flat``/``model`` may be None (zeros) for geometry-only tables
    such as the lights."""
    n0 = np.asarray(tri["n0"], np.float32)
    aux = np.zeros((n0.shape[0], AUX_COLS), np.float32)
    aux[:, 0:3] = n0
    aux[:, 3] = np.asarray(tri["d0"], np.float32)
    aux[:, 4:7] = np.asarray(tri["n1"], np.float32)
    aux[:, 7] = np.asarray(tri["d1"], np.float32)
    aux[:, 8:11] = np.asarray(tri["n2"], np.float32)
    aux[:, 11] = np.asarray(tri["d2"], np.float32)
    if normals_flat is not None:
        aux[:, 12:21] = np.asarray(normals_flat, np.float32)
    if model is not None:
        aux[:, 21] = np.asarray(model, np.float32)
    return aux


def pack_dense_cab(positions, ch: int = CH) -> np.ndarray:
    """Chunk boxes ``[ceil(T/ch), 6]`` (lo xyz, hi xyz) of the table's
    chunks of ``ch`` consecutive rows, ``positions`` ``[T, 3, 3]`` in table
    order: the port's copy of dense_pallas's ``pack_dense_pl_cab`` (equal
    to it at its chunk width). Each box is padded by ``1e-4 * max|pos| +
    1e-6`` on every side, far above the pair test's rounding and far below a
    chunk; an empty pad chunk gets an inverted box (lo = +BIG, hi = -BIG),
    which is never entered."""
    pos = np.asarray(positions, np.float32)
    t = pos.shape[0]
    chunks = -(-t // ch)
    cab = np.empty((chunks, 6), np.float32)
    cab[:, 0:3] = _BIG
    cab[:, 3:6] = -_BIG
    pad = 1e-4 * float(np.abs(pos).max(initial=1.0)) + 1e-6
    for c in range(chunks):
        seg = pos[c * ch : min((c + 1) * ch, t)]
        if seg.size:
            cab[c, 0:3] = seg.min(axis=(0, 1)) - pad
            cab[c, 3:6] = seg.max(axis=(0, 1)) + pad
    return cab


def _table(eng: dict):
    """The table's ``(aux, cab)``; a table without chunk boxes raises."""
    if "cab" not in eng:
        raise ValueError("a dense table needs its chunk boxes 'cab' (pack_dense_cab)")
    return eng["aux"], eng["cab"]


# --- kernel binding ---


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    sig = [i, p, p, i, p, p, p, i, p, p, p]
    return load("dense_hit", {"dense_closest": sig, "dense_any": sig})


def _check_cuda(eng, origin, direction, t_limit, stats):
    aux, cab = _table(eng)
    for name, x in (("aux", aux), ("cab", cab), ("origin", origin), ("direction", direction),
                    ("t_limit", t_limit)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if x.device != origin.device:
            raise ValueError("all tensors must be on one device")
    n, t = origin.shape[0], aux.shape[0]
    if aux.dim() != 2 or aux.shape[1] != AUX_COLS or t > DENSE_MAX_TRIS:
        raise ValueError(f"aux must be [T <= {DENSE_MAX_TRIS}, {AUX_COLS}], got {tuple(aux.shape)}")
    if aux.data_ptr() % 16:
        raise ValueError("aux must be 16-byte aligned (the kernels read it as float4)")
    if cab.shape != (-(-t // CH), 6):
        raise ValueError(f"cab must be [ceil(T/{CH}), 6], got {tuple(cab.shape)}")
    if origin.shape != (n, 3) or direction.shape != (n, 3) or t_limit.shape != (n,):
        raise ValueError("origin/direction must be [N, 3] and t_limit [N]")
    if stats is not None and (stats.device != origin.device or stats.dtype != torch.int64
                              or stats.shape != (NSTATS,)):
        raise ValueError(f"stats must be an int64 [{NSTATS}] tensor on the rays' device")


def _launch(fn, eng, origin, direction, t_limit, out, stats):
    dev = origin.device
    err = fn(
        dev.index, eng["aux"].data_ptr(), eng["cab"].data_ptr(), eng["aux"].shape[0],
        origin.data_ptr(), direction.data_ptr(), t_limit.data_ptr(), origin.shape[0],
        out.data_ptr(), None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def closest_cuda(eng, origin, direction, t_limit, stats=None) -> torch.Tensor:
    """Kernel closest hit over the table ``eng`` (``aux``, ``cab``): ``[N,
    8]`` rows (t, idx, u, v, n_raw xyz, model), idx = -1 and zeros elsewhere
    on a miss. ``stats``, a zeroed int64 CUDA tensor [6], receives (blocks
    with a valid lane, valid lanes, (lane, chunk) box tests that entered,
    chunks staged, lanes listed on a staged chunk, (lane, real row) pairs
    tested) summed over blocks (see `dense_stats`)."""
    _check_cuda(eng, origin, direction, t_limit, stats)
    fn = _lib().dense_closest
    out = torch.empty((origin.shape[0], 8), dtype=torch.float32, device=origin.device)
    LAUNCHES["closest"] += 1
    _launch(fn, eng, origin, direction, t_limit, out, stats)
    return out


def any_cuda(eng, origin, direction, t_limit, stats=None) -> torch.Tensor:
    """Kernel shadow test: bool ``[N]``; ``stats`` as for `closest_cuda`
    (a lane stops testing once occluded)."""
    _check_cuda(eng, origin, direction, t_limit, stats)
    fn = _lib().dense_any
    out = torch.empty(origin.shape[0], dtype=torch.bool, device=origin.device)
    LAUNCHES["any"] += 1
    _launch(fn, eng, origin, direction, t_limit, out, stats)
    return out


# --- plain torch versions (same expressions, same order) ---


def _ray_cols(origin, direction):
    return [origin[:, k : k + 1] for k in range(3)] + [direction[:, k : k + 1] for k in range(3)]


def _search_terms(aux, ox, oy, oz, dx, dy, dz):
    """(det, td, ud, vd) as ``[n, T]`` for rays (``[n, 1]`` columns) x all
    table rows, in dense_hit.cu's expression order."""
    a = aux.T[:, None, :]  # [24, 1, T]
    n0x, n0y, n0z, d0 = a[0], a[1], a[2], a[3]
    n1x, n1y, n1z, d1 = a[4], a[5], a[6], a[7]
    n2x, n2y, n2z, d2 = a[8], a[9], a[10], a[11]
    det = dx * n0x + dy * n0y + dz * n0z
    td = d0 - (ox * n0x + oy * n0y + oz * n0z)
    ud = det * ((ox * n1x + oy * n1y + oz * n1z) + d1) + td * (dx * n1x + dy * n1y + dz * n1z)
    vd = det * ((ox * n2x + oy * n2y + oz * n2z) + d2) + td * (dx * n2x + dy * n2y + dz * n2z)
    return det, td, ud, vd


def _same(a, b):
    return (a >= 0.0) == (b >= 0.0)


def _epilogue(aux, best, origin, direction):
    """Winner's exact t/u/v, unnormalised normal and model id -> ``[n, 8]``."""
    row = aux.index_select(0, best.clamp(min=0))
    row = torch.where((best >= 0)[:, None], row, 0.0)
    ox, oy, oz, dx, dy, dz = [c[:, 0] for c in _ray_cols(origin, direction)]
    col = lambda k: row[:, k]  # noqa: E731
    det = col(0) * dx + col(1) * dy + col(2) * dz
    td = col(3) - (col(0) * ox + col(1) * oy + col(2) * oz)
    px = det * ox + td * dx
    py = det * oy + td * dy
    pz = det * oz + td * dz
    ud = col(4) * px + col(5) * py + col(6) * pz + det * col(7)
    vd = col(8) * px + col(9) * py + col(10) * pz + det * col(11)
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    t = td * inv
    u = ud * inv
    v = vd * inv
    w = 1.0 - u - v
    nx = w * col(12) + u * col(15) + v * col(18)
    ny = w * col(13) + u * col(16) + v * col(19)
    nz = w * col(14) + u * col(17) + v * col(20)
    return torch.stack([t, best.to(t.dtype), u, v, nx, ny, nz, col(21)], dim=1)


def _search(aux, origin, direction, t_limit, tested=None):
    """(best t, best index) of the closest-hit search on one step of rays:
    ``_BIG`` and -1 where nothing hits. ``tested`` (``[n, T]`` bool, or
    None for every pair) limits the search to the pairs it marks."""
    ox, oy, oz, dx, dy, dz = _ray_cols(origin, direction)
    det, td, ud, vd = _search_terms(aux, ox, oy, oz, dx, dy, dz)
    c2 = _same(ud, det - ud)
    c3 = _same(vd, det - ud - vd)
    safe = torch.where(det == 0.0, 1.0, det)
    r = 1.0 / safe
    r = r * (2.0 - safe * r)  # one Newton step, as on the TPU
    t = td * r
    ok = c2 & c3 & (det != 0.0) & (t > EPSILON) & (t < t_limit[:, None])
    if tested is not None:
        ok = ok & tested
    tm = torch.where(ok, t, _BIG)
    best_t = tm.min(dim=1).values
    # first index attaining the minimum: the lowest index wins ties
    first = torch.argmax((tm == best_t[:, None]).to(torch.uint8), dim=1)
    return best_t, torch.where(best_t < _BIG, first, -1)


def _slices(aux, origin):
    """Slices of the rays, each within the plain versions' pairs budget."""
    step = max(1, _PLAIN_PAIRS[origin.device.type] // max(aux.shape[0], 1))
    return [slice(s, s + step) for s in range(0, origin.shape[0], step)]


def closest_search_plain(aux, origin, direction, t_limit):
    """The closest-hit search alone: ``(best_t [N], best [N] int64)``,
    ``_BIG`` and -1 on a miss (any device, any float dtype)."""
    n, dev = origin.shape[0], origin.device
    best_t = torch.full((n,), _BIG, dtype=origin.dtype, device=dev)
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for sl in _slices(aux, origin):
        best_t[sl], best[sl] = _search(aux, origin[sl], direction[sl], t_limit[sl])
    return best_t, best


def closest_plain(aux, origin, direction, t_limit) -> torch.Tensor:
    """Plain version of `closest_cuda` (any device, any float dtype: run in
    float64 it is the precision oracle)."""
    out = []
    for sl in _slices(aux, origin):
        o, d = origin[sl], direction[sl]
        out.append(_epilogue(aux, _search(aux, o, d, t_limit[sl])[1], o, d))
    if not out:
        return torch.zeros((0, 8), dtype=origin.dtype, device=origin.device)
    return torch.cat(out, dim=0)


def _valid(origin, direction, t_limit):
    """Live lanes (every kernel's): t_limit > 0 and a finite origin and
    direction; no other lane can hit."""
    return ((t_limit > 0.0) & torch.isfinite(origin).all(dim=1)
            & torch.isfinite(direction).all(dim=1))


def _shadow_hits(aux, o, d, tl):
    """``[n, T]``: whether each ray hits each row with EPSILON < t < tl
    (``tl`` ``[n, 1]``), dense_hit.cu's division-free shadow test."""
    det, td, ud, vd = _search_terms(aux, *_ray_cols(o, d))
    c1 = _same(td - det * EPSILON, det * tl - td)
    c2 = _same(ud, det - ud)
    c3 = _same(vd, det - ud - vd)
    return c1 & c2 & c3 & (det != 0.0)


def any_plain(aux, origin, direction, t_limit) -> torch.Tensor:
    """Plain version of `any_cuda`."""
    out = [_shadow_hits(aux, origin[sl], direction[sl], t_limit[sl, None]).any(dim=1)
           for sl in _slices(aux, origin)]
    if not out:
        return torch.zeros(0, dtype=torch.bool, device=origin.device)
    return torch.cat(out) & _valid(origin, direction, t_limit)


# --- the kernels' cull, as a plain model (tests, chip_smoke.py) ---


def _entered_rows(eng, o, d, tw):
    """``[n, T]``: the rows of the chunks whose box each ray's own segment
    test (`walk.lane_enters`, the kernels' ``segment.cuh`` enters) enters
    within its window ``tw`` ``[n]``."""
    from path_tracer_tpu_torch.trace.walk import lane_enters  # walk imports this module

    aux, cab = _table(eng)
    enter = lane_enters(cab[:, 0:3], cab[:, 3:6], o, d, tw)
    return enter.repeat_interleave(CH, dim=1)[:, : aux.shape[0]]


def culled_closest_plain(eng, origin, direction, t_limit) -> torch.Tensor:
    """The closest hit through the kernels' cull at its tightest: a lane
    tests a chunk's rows only if its segment enters the chunk's box within
    ``min(t*, t_limit)``, t* its plain closest t (the least window a kernel
    lane can reach). ``[N, 8]`` rows as `closest_plain`, equal to them when
    the cull is exact."""
    aux, _ = _table(eng)
    t_star, _ = closest_search_plain(aux, origin, direction, t_limit)
    valid = _valid(origin, direction, t_limit)
    out = []
    for sl in _slices(aux, origin):
        o, d, tl = origin[sl], direction[sl], t_limit[sl]
        tested = _entered_rows(eng, o, d, torch.minimum(t_star[sl], tl)) & valid[sl, None]
        out.append(_epilogue(aux, _search(aux, o, d, tl, tested)[1], o, d))
    if not out:
        return torch.zeros((0, 8), dtype=origin.dtype, device=origin.device)
    return torch.cat(out, dim=0)


def culled_any_plain(eng, origin, direction, t_limit) -> torch.Tensor:
    """The any hit through the kernels' cull: a lane tests a chunk's rows
    only if its segment enters the chunk's box within its t_limit. Equal to
    `any_plain` when the cull is exact."""
    aux, _ = _table(eng)
    out = []
    for sl in _slices(aux, origin):
        o, d, tl = origin[sl], direction[sl], t_limit[sl]
        hits = _shadow_hits(aux, o, d, tl[:, None]) & _entered_rows(eng, o, d, tl)
        out.append(hits.any(dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.bool, device=origin.device)
    return torch.cat(out) & _valid(origin, direction, t_limit)


TIE_ROWS = (1001, 1002, 1920)  # `tie_soup`'s copies of its triangle T


def tie_soup():
    """A table on which every closest hit ties (tests, chip_smoke.py):
    `walk.tie_soup`'s 2,048 triangles (16 chunks of ``CH``) and rays, its
    triangle T (row 2047, the last of chunk 15, every ray's closest hit)
    also copied to rows 1001 and 1002 (twice in chunk 7) and 1920 (chunk
    15's first row). The lowest index, 1001, must win every ray. Returns
    (positions [2048, 3, 3], origin [1024, 3], direction [1024, 3]),
    float32 NumPy."""
    from path_tracer_tpu_torch.trace.walk import tie_soup as walk_tie_soup

    pos, o, d = walk_tie_soup()
    pos = pos.copy()
    pos[list(TIE_ROWS)] = pos[-1]
    return pos, o, d


# --- public queries (the dense_pl_* contract) ---


def _rays(origin, direction, t_limit):
    f32 = torch.float32
    return (
        origin.to(f32).contiguous(),
        direction.to(f32).contiguous(),
        torch.clamp(t_limit.to(f32), max=_T_CLAMP).contiguous(),
    )


def _closest_rows(eng, origin, direction, t_limit):
    aux, _ = _table(eng)
    o, d, tl = _rays(origin, direction, t_limit)
    if o.device.type == "cpu":
        return closest_plain(aux, o, d, tl)
    return closest_cuda(eng, o, d, tl)


def dense_closest_hit_shade(eng: dict, origin, direction, t_limit):
    """Closest hit + fused shading fetch over the table ``eng`` (``aux``,
    ``cab``). Returns ``(tri_idx i32, t, u, v, normal_raw [N,3], model
    i32)``; on a miss idx = -1, t = t_limit, u = v = 0. The normal is the
    unnormalised barycentric interpolation."""
    out = _closest_rows(eng, origin, direction, t_limit)
    best = out[:, 1].to(torch.int32)
    hit = best >= 0
    t = torch.where(hit, out[:, 0], t_limit)
    u = torch.where(hit, out[:, 2], 0.0)
    v = torch.where(hit, out[:, 3], 0.0)
    return best, t, u, v, out[:, 4:7], out[:, 7].to(torch.int32)


def dense_closest_hit(eng: dict, origin, direction, t_limit):
    """``(tri_idx, t, u, v)``, the `traversal.closest_hit` contract."""
    best, t, u, v, _, _ = dense_closest_hit_shade(eng, origin, direction, t_limit)
    return best, t, u, v


def dense_any_hit(eng: dict, origin, direction, t_limit) -> torch.Tensor:
    """True where a hit with EPSILON < t < t_limit exists."""
    aux, _ = _table(eng)
    o, d, tl = _rays(origin, direction, t_limit)
    if o.device.type == "cpu":
        return any_plain(aux, o, d, tl)
    return any_cuda(eng, o, d, tl)


def dense_stats(eng: dict, origin, direction, t_limit, query: str = "closest") -> dict:
    """The cull's economics of one ``query`` ("closest" or "any") on the
    card, on the public query's rays: ``blocks`` (with a valid lane),
    ``lanes`` (valid lanes), ``entered`` ((lane, chunk) box tests that
    entered), ``staged`` (chunks staged), ``listed`` (lanes listed on a
    staged chunk), ``pairs`` ((lane, real row) pairs tested), summed over
    blocks. CUDA tensors only."""
    o, d, tl = _rays(origin, direction, t_limit)
    stats = torch.zeros(NSTATS, dtype=torch.int64, device=o.device)
    (closest_cuda if query == "closest" else any_cuda)(eng, o, d, tl, stats=stats)
    keys = ("blocks", "lanes", "entered", "staged", "listed", "pairs")
    return dict(zip(keys, (int(x) for x in stats.cpu())))
