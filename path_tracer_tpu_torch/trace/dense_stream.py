"""Streamed dense engine: closest hit and any hit over one soup of up to 2M
triangles in fixed-stride parts of 512-triangle chunks, for baked world
soups when the walk is switched off (``PT_WALK=0``, or
``Scene.device(..., engine="stream")``) and for soups above the walk's
1,572,864 triangles. The CUDA kernels of ``csrc/dense_stream.cu``, their
plain torch versions, the plain model of the kernels' cull, the host
packing, and the public queries.

Port of ``path_tracer_tpu/trace/dense_stream.py`` (``_stream_closest_kernel``
and ``_stream_any_kernel``, reached through ``dense_stream_closest_hit_shade``
and ``dense_stream_any_hit``):

* Host packing (`pack_dense_stream`): ``aux`` holds one row per triangle in
  the soup's own order, padded to a fixed part stride so that a row index is
  the soup index (pad rows are zero: det == 0, they never hit); ``cab`` the
  chunk boxes (inverted for pad chunks) and ``pab`` the part boxes, both
  padded by 1e-4 of the scene's coordinate scale: these three are bit-equal
  to the JAX package's (``JAX_TABLES``). The port adds ``qab``, the boxes of
  every group of 128 rows (`pack_qab`: `dense_cuda.pack_dense_cab`'s rule,
  the same pad, inverted for pad groups). The JAX package's MXU weight table
  ``w`` is not carried over: the kernels read the planes from ``aux``. The
  device dict (`upload`) holds ``TABLES``; a table without ``qab`` raises.
* The kernels cull per lane in three levels, each lane's own slab test
  against the part boxes, the chunk boxes of the parts it enters and the
  group boxes of the chunks it enters, within its own window; each group
  some lane enters is tested against the rays listed on it, one row per
  thread, with the dense kernels' pair test (`trace.dense_cuda`): search
  only (best t and the winner's row), as on the TPU. `culled_closest_plain`
  and `culled_any_plain` are that cull as a plain model (tests and
  ``chip_smoke.py``).
* Around the kernels (torch ops): the epilogue gathers the winner's ``aux``
  row and recomputes the exact t/u/v in ``traversal._tri_intersect`` order
  (`dense_cuda._epilogue`). Rays are taken in the caller's order (no sort).
* Plain versions: the dense engine's ungated search over every row
  (`dense_cuda.closest_search_plain`, `dense_cuda.any_plain`): the lowest
  row index among equal search t wins, as in the kernels, which visit groups
  in ascending order and keep a strictly nearer hit.

Each kernel has one wrapper: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises. ``LAUNCHES["stream_closest"]`` and
``LAUNCHES["stream_any"]`` count the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from path_tracer_tpu_torch.trace import dense_cuda
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES, load
from path_tracer_tpu_torch.trace.dense_cuda import AUX_COLS, _epilogue, _valid
from path_tracer_tpu_torch.trace.walk import lane_enters
from path_tracer_tpu_torch.trace.walk import tie_soup as walk_tie_soup

PART_TRIS = 16384  # triangles per part
CH = 512  # triangles per chunk
QH = 128  # triangles per group (csrc/dense_stream.cu QH)
SBLK = 128  # rays per block
DENSE_STREAM_MAX_TRIS = 2_000_000  # the engine's limit
NSTATS = 8  # the kernels' counters (`stream_stats`)
_BIG = 1e30  # "no winner" sentinel, as in dense_stream
JAX_TABLES = ("aux", "cab", "pab")  # bit-equal to the JAX package's
TABLES = JAX_TABLES + ("qab",)  # what the engine keeps on the device


# --- host packing (NumPy) ---


def _part_geometry(n_tris: int) -> tuple[int, int, int]:
    """(nparts, per, part_tp): fixed-stride parts (``per == part_tp``), pad
    only in the trailing part, so a padded row index equals the soup index."""
    if n_tris <= PART_TRIS:
        part_tp = -(-n_tris // CH) * CH
        return 1, part_tp, part_tp
    return -(-n_tris // PART_TRIS), PART_TRIS, PART_TRIS


def pack_qab(positions, n_rows: int) -> np.ndarray:
    """Group boxes ``[n_rows // QH, 6]`` of the soup ``positions`` ``[T, 3,
    3]`` laid out in ``n_rows`` rows (``aux``'s): `dense_cuda.pack_dense_cab`
    at ``QH`` rows per group for the groups that hold triangles, inverted
    boxes for the pad groups after them."""
    qab = np.empty((n_rows // QH, 6), np.float32)
    qab[:, 0:3] = _BIG
    qab[:, 3:6] = -_BIG
    real = dense_cuda.pack_dense_cab(positions, QH)
    qab[: real.shape[0]] = real
    return qab


def pack_dense_stream(tri: dict, normals_flat, model, positions) -> dict:
    """Pack the streamed engine's tables (host numpy): ``aux``
    [nparts*part_tp, 24] plane + shading rows in padded soup order; ``cab``
    [nparts*cpp, 6] chunk boxes (lo xyz | hi xyz; inverted for pad chunks);
    ``pab`` [nparts, 6] part boxes; ``qab`` [nparts*cpp*4, 6] group boxes
    (`pack_qab`); ``meta`` the static sizes."""
    n0 = np.asarray(tri["n0"], np.float32)
    t = n0.shape[0]
    if t > DENSE_STREAM_MAX_TRIS:
        raise ValueError(f"the streamed engine caps at {DENSE_STREAM_MAX_TRIS} tris, got {t}")
    nparts, per, part_tp = _part_geometry(t)
    cpp = part_tp // CH
    pos = np.asarray(positions, np.float32)

    aux = np.zeros((nparts * part_tp, AUX_COLS), np.float32)
    aux[:t] = dense_cuda.pack_dense_aux(tri, normals_flat, model)
    cab = np.empty((nparts * cpp, 6), np.float32)
    cab[:, 0:3] = _BIG
    cab[:, 3:6] = -_BIG
    pab = np.empty((nparts, 6), np.float32)
    pad = 1e-4 * float(np.abs(pos).max(initial=1.0)) + 1e-6
    for p in range(nparts):
        lo, hi = p * per, min((p + 1) * per, t)
        seg_p = pos[lo:hi]
        pab[p, 0:3] = seg_p.min(axis=(0, 1)) - pad
        pab[p, 3:6] = seg_p.max(axis=(0, 1)) + pad
        for c in range(cpp):
            seg = pos[lo + c * CH : min(lo + (c + 1) * CH, hi)]
            if seg.size:
                cab[p * cpp + c, 0:3] = seg.min(axis=(0, 1)) - pad
                cab[p * cpp + c, 3:6] = seg.max(axis=(0, 1)) + pad
    return {
        "aux": aux, "cab": cab, "pab": pab, "qab": pack_qab(pos, aux.shape[0]),
        "meta": {"nparts": nparts, "per": per, "part_tp": part_tp, "cpp": cpp, "n_tris": t},
    }


def upload(tables: dict, device) -> dict:
    """The engine's dict from `pack_dense_stream`'s tables: ``TABLES`` as
    tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(tables[k])).to(device) for k in TABLES}


def _table(eng: dict) -> dict:
    """``eng``; a table without its group boxes raises."""
    if "qab" not in eng:
        raise ValueError("a stream table needs its group boxes 'qab' (pack_qab)")
    return eng


def num_parts(eng: dict) -> int:
    return eng["pab"].shape[0]


def table_bytes(eng: dict) -> int:
    """Bytes of the engine's tables."""
    return sum(eng[k].numel() * eng[k].element_size() for k in TABLES)


# --- kernel binding ---


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return load("dense_stream", {
        "stream_closest": [i, p, p, p, p, i, i, p, p, p, i, p, p, p, p],
        "stream_any": [i, p, p, p, p, i, i, p, p, p, i, p, p, p],
    })


def _check_cuda(eng, origin, direction, t_limit, stats):
    _table(eng)
    dev = origin.device
    for name, x in (("aux", eng["aux"]), ("cab", eng["cab"]), ("pab", eng["pab"]),
                    ("qab", eng["qab"]), ("origin", origin), ("direction", direction),
                    ("t_limit", t_limit)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != dev:
            raise ValueError("all tensors must be on one device")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    aux, cab, pab, qab = eng["aux"], eng["cab"], eng["pab"], eng["qab"]
    if aux.data_ptr() % 16:
        raise ValueError("aux must be 16-byte aligned (the kernels read it as float4)")
    nparts = pab.shape[0]
    if (pab.dim() != 2 or pab.shape[1] != 6 or cab.dim() != 2 or cab.shape[1] != 6
            or nparts == 0 or cab.shape[0] % nparts):
        raise ValueError("cab must be [nparts*cpp, 6] and pab [nparts, 6]")
    cpp = cab.shape[0] // nparts
    if not 1 <= cpp <= PART_TRIS // CH:
        raise ValueError(f"{cpp} chunks per part: the kernels take 1 to {PART_TRIS // CH}")
    if nparts > -(-DENSE_STREAM_MAX_TRIS // PART_TRIS):
        raise ValueError(f"{nparts} parts: the kernels take at most "
                         f"{-(-DENSE_STREAM_MAX_TRIS // PART_TRIS)}")
    if aux.dim() != 2 or aux.shape != (cab.shape[0] * CH, AUX_COLS):
        raise ValueError(f"aux must be [{cab.shape[0] * CH}, {AUX_COLS}], got {tuple(aux.shape)}")
    if qab.shape != (aux.shape[0] // QH, 6):
        raise ValueError(f"qab must be [{aux.shape[0] // QH}, 6], got {tuple(qab.shape)}")
    n = origin.shape[0]
    if origin.shape != (n, 3) or direction.shape != (n, 3) or t_limit.shape != (n,):
        raise ValueError("origin/direction must be [N, 3] and t_limit [N]")
    if stats is not None and (stats.device != dev or stats.dtype != torch.int64
                              or stats.shape != (NSTATS,)):
        raise ValueError(f"stats must be an int64 [{NSTATS}] tensor on the rays' device")
    return (dev.index, aux.data_ptr(), cab.data_ptr(), pab.data_ptr(), qab.data_ptr(), nparts,
            cpp, origin.data_ptr(), direction.data_ptr(), t_limit.data_ptr(), n)


def closest_cuda(eng, origin, direction, t_limit, stats=None):
    """Kernel closest-hit search (t_limit clamped finite). Returns
    ``(best_t [N] f32, idx [N] i32)``: the search t and the winner's soup
    index, 1e30 and -1 on a miss. ``stats``, a zeroed int64 CUDA tensor
    [8], receives the cull's counters summed over blocks (see
    `stream_stats`)."""
    args = _check_cuda(eng, origin, direction, t_limit, stats)
    fn = _lib().stream_closest
    n = origin.shape[0]
    best_t = torch.empty(n, dtype=torch.float32, device=origin.device)
    idx = torch.empty(n, dtype=torch.int32, device=origin.device)
    LAUNCHES["stream_closest"] += 1
    err = fn(*args, best_t.data_ptr(), idx.data_ptr(),
             None if stats is None else stats.data_ptr(),
             torch.cuda.current_stream(origin.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_closest launch failed: cudaError {err}")
    return best_t, idx


def any_cuda(eng, origin, direction, t_limit, stats=None):
    """Kernel shadow test (t_limit clamped finite): bool ``[N]``, False on
    dead and non-finite lanes. ``stats`` as for `closest_cuda`."""
    args = _check_cuda(eng, origin, direction, t_limit, stats)
    fn = _lib().stream_any
    out = torch.empty(origin.shape[0], dtype=torch.bool, device=origin.device)
    LAUNCHES["stream_any"] += 1
    err = fn(*args, out.data_ptr(), None if stats is None else stats.data_ptr(),
             torch.cuda.current_stream(origin.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_any launch failed: cudaError {err}")
    return out


# --- plain torch versions (ungated) ---


def closest_plain(eng, origin, direction, t_limit):
    """Plain version of `closest_cuda` (any device, any float dtype: run in
    float64 it is the precision oracle): the dense search over every row of
    ``aux`` for the live lanes (only ``aux`` is read)."""
    n, dev = origin.shape[0], origin.device
    best_t = torch.full((n,), _BIG, dtype=origin.dtype, device=dev)
    idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    live = _valid(origin, direction, t_limit).nonzero()[:, 0]
    if live.numel():
        aux = eng["aux"].to(origin.dtype)
        bt, bi = dense_cuda.closest_search_plain(aux, origin[live], direction[live], t_limit[live])
        best_t[live] = bt
        idx[live] = bi.to(torch.int32)
    return best_t, idx


def any_plain(eng, origin, direction, t_limit):
    """Plain version of `any_cuda`: an ungated OR over every row."""
    return dense_cuda.any_plain(eng["aux"], origin, direction, t_limit)


# --- the kernels' cull, as a plain model (tests, chip_smoke.py) ---


def entered_groups(eng, o, d, tw):
    """``[n, G]``: whether each ray's own segment test (`walk.lane_enters`,
    the kernels' ``segment.cuh`` enters) within its window ``tw`` ``[n]``
    enters group g's part box, its chunk box and its own box."""
    pab, cab, qab = eng["pab"], eng["cab"], _table(eng)["qab"]
    part = lane_enters(pab[:, 0:3], pab[:, 3:6], o, d, tw)
    chunk = lane_enters(cab[:, 0:3], cab[:, 3:6], o, d, tw)
    group = lane_enters(qab[:, 0:3], qab[:, 3:6], o, d, tw)
    return (part.repeat_interleave(qab.shape[0] // pab.shape[0], dim=1)
            & chunk.repeat_interleave(CH // QH, dim=1) & group)


def _entered_rows(eng, o, d, tw):
    return entered_groups(eng, o, d, tw).repeat_interleave(QH, dim=1)


def culled_closest_plain(eng, origin, direction, t_limit):
    """The closest hit through the kernels' three-level cull at its
    tightest: a lane tests a group's rows only if its segment enters the
    group's part, chunk and group boxes within ``min(t*, t_limit)``, t* its
    plain closest t (the least window a kernel lane can reach). ``(best_t,
    idx)`` as `closest_plain`, equal to it when the cull is exact."""
    aux = eng["aux"].to(origin.dtype)
    n, dev = origin.shape[0], origin.device
    t_star, _ = dense_cuda.closest_search_plain(aux, origin, direction, t_limit)
    valid = _valid(origin, direction, t_limit)
    best_t = torch.full((n,), _BIG, dtype=origin.dtype, device=dev)
    idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for sl in dense_cuda._slices(aux, origin):
        o, d, tl = origin[sl], direction[sl], t_limit[sl]
        tested = _entered_rows(eng, o, d, torch.minimum(t_star[sl], tl)) & valid[sl, None]
        bt, bi = dense_cuda._search(aux, o, d, tl, tested)
        best_t[sl], idx[sl] = bt, bi.to(torch.int32)
    return best_t, idx


def culled_any_plain(eng, origin, direction, t_limit):
    """The any hit through the kernels' cull: a lane tests a group's rows
    only if its segment enters the group's part, chunk and group boxes
    within its t_limit. Equal to `any_plain` when the cull is exact."""
    aux = eng["aux"]
    out = []
    for sl in dense_cuda._slices(aux, origin):
        o, d, tl = origin[sl], direction[sl], t_limit[sl]
        hits = dense_cuda._shadow_hits(aux, o, d, tl[:, None]) & _entered_rows(eng, o, d, tl)
        out.append(hits.any(dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.bool, device=origin.device)
    return torch.cat(out) & _valid(origin, direction, t_limit)


TIE_ROWS = (1001, 1002, PART_TRIS + 16)  # `tie_soup`'s copies of its triangle T


def tie_soup():
    """A two-part soup on which every closest hit ties (tests,
    chip_smoke.py): `walk.tie_soup` with 16,400 scattered triangles and its
    triangle T last (row 16,400, in part 1), T also copied to rows 1001 and
    1002 (twice in group 7 of part 0). The lowest index, 1001, must win
    every ray. Returns (positions [16401, 3, 3], origin [512, 3], direction
    [512, 3]), float32 NumPy: every other ray of `walk.tie_soup`'s, each
    octant's block halved."""
    pos, o, d = walk_tie_soup(n=TIE_ROWS[-1])
    pos = pos.copy()
    pos[list(TIE_ROWS[:-1])] = pos[-1]
    return pos, o[::2].copy(), d[::2].copy()


# --- public queries (the JAX dense_stream_* contracts) ---


def dense_stream_closest_hit_shade(eng: dict, origin, direction, t_limit):
    """Closest hit + shading attributes: ``(tri_idx i32, t, u, v,
    normal_raw [N,3], model i32)``, tri_idx in soup order, -1 on a miss
    (t = t_limit, u = v = 0, zero normal and model)."""
    o, d, tl = dense_cuda._rays(origin, direction, t_limit)
    if o.device.type == "cpu":
        _, idx = closest_plain(_table(eng), o, d, tl)
    else:
        _, idx = closest_cuda(eng, o, d, tl)
    out = _epilogue(eng["aux"], idx, o, d)
    hit = idx >= 0
    t = torch.where(hit, out[:, 0], t_limit.to(torch.float32))
    u = torch.where(hit, out[:, 2], 0.0)
    v = torch.where(hit, out[:, 3], 0.0)
    return idx, t, u, v, out[:, 4:7], out[:, 7].to(torch.int32)


def dense_stream_closest_hit(eng: dict, origin, direction, t_limit):
    """``(tri_idx, t, u, v)``, the `traversal.closest_hit` contract."""
    idx, t, u, v, _, _ = dense_stream_closest_hit_shade(eng, origin, direction, t_limit)
    return idx, t, u, v


def dense_stream_any_hit(eng: dict, origin, direction, t_limit) -> torch.Tensor:
    """True where a hit with EPSILON < t < t_limit exists."""
    o, d, tl = dense_cuda._rays(origin, direction, t_limit)
    if o.device.type == "cpu":
        return any_plain(_table(eng), o, d, tl)
    return any_cuda(eng, o, d, tl)


def stream_stats(eng: dict, origin, direction, t_limit, query: str = "closest") -> dict:
    """The cull's economics of one ``query`` ("closest" or "any") on the
    card, in the caller's ray order: ``blocks`` (with a valid lane),
    ``lanes`` (valid lanes), ``parts``, ``chunks`` and ``groups`` ((lane,
    box) tests that entered, at each level), ``staged`` (groups staged:
    those some lane lists), ``listed`` (lanes listed on a staged group),
    ``pairs`` ((lane, row) pairs tested, pad rows of the soup's last group
    included), summed over blocks. CUDA tensors only."""
    o, d, tl = dense_cuda._rays(origin, direction, t_limit)
    stats = torch.zeros(NSTATS, dtype=torch.int64, device=o.device)
    (closest_cuda if query == "closest" else any_cuda)(eng, o, d, tl, stats=stats)
    keys = ("blocks", "lanes", "groups", "staged", "listed", "pairs", "parts", "chunks")
    return dict(zip(keys, (int(x) for x in stats.cpu())))
