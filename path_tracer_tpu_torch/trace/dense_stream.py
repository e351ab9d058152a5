"""Streamed dense engine: closest hit and any hit over one soup of up to 2M
triangles in fixed-stride parts of 512-triangle chunks, for baked world
soups when the walk is switched off (``PT_WALK=0``, or
``Scene.device(..., engine="stream")``) and for soups above the walk's
1,572,864 triangles. The CUDA kernels of ``csrc/dense_stream.cu``, their
plain torch versions, the host packing, and the public queries.

Port of ``path_tracer_tpu/trace/dense_stream.py`` (``_stream_closest_kernel``
and ``_stream_any_kernel``, reached through ``dense_stream_closest_hit_shade``
and ``dense_stream_any_hit``):

* Host packing (`pack_dense_stream`, bit-equal to the JAX tables it keeps):
  ``aux`` holds one row per triangle in the soup's own order, padded to a
  fixed part stride so that a row index is the soup index (pad rows are
  zero: det == 0, they never hit); ``cab`` the chunk boxes (inverted for pad
  chunks) and ``pab`` the part boxes, both padded by 1e-4 of the scene's
  coordinate scale. The JAX package's MXU weight table ``w`` is not carried
  over: the kernels read the planes from ``aux``.
* The kernels gate parts, then chunks, against each 128-ray block's
  conservative bounds and its shrinking t-window, then each lane's own slab
  test against the chunk box, and test the staged chunks' triangles with
  the dense kernels' pair test (`trace.dense_cuda`): search only (best t and
  the winner's row), as on the TPU.
* Around the kernels (torch ops): the epilogue gathers the winner's ``aux``
  row and recomputes the exact t/u/v in ``traversal._tri_intersect`` order
  (`dense_cuda._epilogue`). Rays are taken in the caller's order (no sort).
* Plain versions: the dense engine's ungated search over every row
  (`dense_cuda.closest_search_plain`, `dense_cuda.any_plain`): the lowest
  row index among equal search t wins, as in the kernels, which visit chunks
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

PART_TRIS = 16384  # triangles per part
CH = 512  # triangles per chunk
SBLK = 128  # rays per block
DENSE_STREAM_MAX_TRIS = 2_000_000  # the engine's limit
_BIG = 1e30  # "no winner" sentinel, as in dense_stream
TABLES = ("aux", "cab", "pab")  # what the engine keeps on the device


# --- host packing (NumPy) ---


def _part_geometry(n_tris: int) -> tuple[int, int, int]:
    """(nparts, per, part_tp): fixed-stride parts (``per == part_tp``), pad
    only in the trailing part, so a padded row index equals the soup index."""
    if n_tris <= PART_TRIS:
        part_tp = -(-n_tris // CH) * CH
        return 1, part_tp, part_tp
    return -(-n_tris // PART_TRIS), PART_TRIS, PART_TRIS


def pack_dense_stream(tri: dict, normals_flat, model, positions) -> dict:
    """Pack the streamed engine's tables (host numpy): ``aux``
    [nparts*part_tp, 24] plane + shading rows in padded soup order; ``cab``
    [nparts*cpp, 6] chunk boxes (lo xyz | hi xyz; inverted for pad chunks);
    ``pab`` [nparts, 6] part boxes; ``meta`` the static sizes."""
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
        "aux": aux, "cab": cab, "pab": pab,
        "meta": {"nparts": nparts, "per": per, "part_tp": part_tp, "cpp": cpp, "n_tris": t},
    }


def num_parts(eng: dict) -> int:
    return eng["pab"].shape[0]


def table_bytes(eng: dict) -> int:
    """Bytes of the engine's tables."""
    return sum(eng[k].numel() * eng[k].element_size() for k in TABLES)


# --- kernel binding ---


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return load("dense_stream", {
        "stream_closest": [i, p, p, p, i, i, p, p, p, i, p, p, p, p],
        "stream_any": [i, p, p, p, i, i, p, p, p, i, p, p, p],
    })


def _check_cuda(eng, origin, direction, t_limit, stats):
    dev = origin.device
    for name, x in (("aux", eng["aux"]), ("cab", eng["cab"]), ("pab", eng["pab"]),
                    ("origin", origin), ("direction", direction), ("t_limit", t_limit)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != dev:
            raise ValueError("all tensors must be on one device")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    aux, cab, pab = eng["aux"], eng["cab"], eng["pab"]
    if aux.data_ptr() % 16:
        raise ValueError("aux must be 16-byte aligned (the kernels read it as float4)")
    nparts = pab.shape[0]
    if (pab.dim() != 2 or pab.shape[1] != 6 or cab.dim() != 2 or cab.shape[1] != 6
            or nparts == 0 or cab.shape[0] % nparts):
        raise ValueError("cab must be [nparts*cpp, 6] and pab [nparts, 6]")
    cpp = cab.shape[0] // nparts
    if not 1 <= cpp <= PART_TRIS // CH:
        raise ValueError(f"{cpp} chunks per part: the kernels take 1 to {PART_TRIS // CH}")
    if aux.dim() != 2 or aux.shape != (cab.shape[0] * CH, AUX_COLS):
        raise ValueError(f"aux must be [{cab.shape[0] * CH}, {AUX_COLS}], got {tuple(aux.shape)}")
    n = origin.shape[0]
    if origin.shape != (n, 3) or direction.shape != (n, 3) or t_limit.shape != (n,):
        raise ValueError("origin/direction must be [N, 3] and t_limit [N]")
    if stats is not None and (stats.device != dev or stats.dtype != torch.int64
                              or stats.shape != (5,)):
        raise ValueError("stats must be an int64 [5] tensor on the rays' device")
    return (dev.index, aux.data_ptr(), cab.data_ptr(), pab.data_ptr(), nparts, cpp,
            origin.data_ptr(), direction.data_ptr(), t_limit.data_ptr(), n)


def closest_cuda(eng, origin, direction, t_limit, stats=None):
    """Kernel closest-hit search (t_limit clamped finite). Returns
    ``(best_t [N] f32, idx [N] i32)``: the search t and the winner's soup
    index, 1e30 and -1 on a miss. ``stats``, a zeroed int64 CUDA tensor [5],
    receives (blocks with a live lane, parts admitted, chunks passing the
    block gate and window, chunks staged, lanes testing a staged chunk)
    summed over blocks."""
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
    ``aux`` for the live lanes."""
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


# --- public queries (the JAX dense_stream_* contracts) ---


def dense_stream_closest_hit_shade(eng: dict, origin, direction, t_limit):
    """Closest hit + shading attributes: ``(tri_idx i32, t, u, v,
    normal_raw [N,3], model i32)``, tri_idx in soup order, -1 on a miss
    (t = t_limit, u = v = 0, zero normal and model)."""
    o, d, tl = dense_cuda._rays(origin, direction, t_limit)
    if o.device.type == "cpu":
        _, idx = closest_plain(eng, o, d, tl)
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
        return any_plain(eng, o, d, tl)
    return any_cuda(eng, o, d, tl)


def stream_stats(eng: dict, origin, direction, t_limit, query: str = "closest") -> dict:
    """Gate economics of one ``query`` ("closest" or "any") on the card, in
    the caller's ray order: ``blocks`` (with a live lane), ``parts``
    (admitted by a block), ``gated`` (chunks passing a block's gate and
    window), ``staged`` (chunks a lane entered, tested by the block) and
    ``lane_visits`` (lanes testing a staged chunk), summed over blocks.
    CUDA tensors only."""
    o, d, tl = dense_cuda._rays(origin, direction, t_limit)
    stats = torch.zeros(5, dtype=torch.int64, device=o.device)
    (closest_cuda if query == "closest" else any_cuda)(eng, o, d, tl, stats=stats)
    blocks, parts, gated, staged, lanes = (int(x) for x in stats.cpu())
    return {"blocks": blocks, "parts": parts, "gated": gated, "staged": staged,
            "lane_visits": lanes}
