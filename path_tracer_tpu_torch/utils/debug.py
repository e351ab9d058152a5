"""Debug-mode validation: the analog of the reference's ``debug_assert!``
layer (port of ``path_tracer_tpu/utils/debug.py``).

The reference checks invariants in debug builds along the hot path (ray
normalization ``ray.rs:12``, AABB ordering ``boundingbox.rs:42``, ONB
orthonormality ``onb.rs:3``, Sobol range ``sampling.rs:110``, tonemap
parameter ranges ``tonemapping.rs:70-73``). What is worth checking here is
data: the host scene at build time (`validate_scene`), a render's outputs
(`validate_render_outputs`, `debug_render`), and the port's own engine
tables (`validate_walk_engine`: the walk, vwalk, iwalk and stream tables).
All checks run on the host and cost nothing unless called.
"""

from __future__ import annotations

import numpy as np
import torch


class SceneValidationError(AssertionError):
    pass


def _check(cond: bool, msg: str):
    if not cond:
        raise SceneValidationError(msg)


def _a(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def validate_scene(scene_host) -> None:
    """Structural invariants of a built `scene.scene.Scene`."""
    if scene_host.bvh is not None:  # a baked world soup
        bvh, t = scene_host.bvh, scene_host.num_world_tris
        # AABB ordering (boundingbox.rs:42) for every real child
        for c in ("c0", "c1"):
            valid = bvh[f"{c}_count"] != -1
            _check(bool((bvh[f"{c}_min"][valid] <= bvh[f"{c}_max"][valid] + 1e-6).all()),
                   f"{c} AABB min > max")
        # leaves cover each primitive exactly once
        cover = np.zeros(t + 1, np.int64)
        for c in ("c0", "c1"):
            leaf = bvh[f"{c}_count"] > 0
            start = bvh[f"{c}_idx"][leaf].astype(np.int64)
            end = start + bvh[f"{c}_count"][leaf]
            _check(bool((start >= 0).all() and (end <= t).all()), "BVH leaf outside the soup")
            np.add.at(cover, start, 1)
            np.add.at(cover, end, -1)
        _check(bool((np.cumsum(cover)[:t] == 1).all()), "BVH leaves do not partition primitives")
        _check(bool((np.sort(scene_host.perm) == np.arange(t)).all()),
               "the SAH order is not a permutation of the soup")
        # triangle data finite; shading normals non-degenerate
        for key in ("n0", "n1", "n2", "d0", "d1", "d2"):
            _check(bool(np.isfinite(scene_host.tri[key]).all()), f"non-finite tri field {key}")
        nrm = scene_host.tri["normals"].reshape(-1, 3)
        _check(bool((np.linalg.norm(nrm, axis=-1) > 0).all()), "zero-length shading normal")

    # light CDF monotone, ends at ~1 (light_sampler.rs:41-61)
    if scene_host.has_lights:
        cdf = scene_host.light["cdf"]
        _check(bool((np.diff(cdf) >= -1e-7).all()), "light CDF not monotone")
        _check(abs(float(cdf[-1]) - 1.0) < 1e-4, "light CDF does not end at 1")
        _check(bool((scene_host.light["pdf"] >= 0).all()), "negative light pdf")

    # material parameter ranges (material.rs:294: a in [1e-4, 0.9999])
    mat = scene_host.mat
    ggx = (mat["mtype"] == 3) | (mat["mtype"] == 4)
    if ggx.any():
        a = mat["ggx_a"][ggx]
        _check(bool(((a >= 1e-4) & (a <= 0.9999)).all()), "GGX alpha out of range")
    _check(bool((mat["ior"] > 0).all()), "non-positive IOR")

    # environment image finite
    _check(bool(np.isfinite(scene_host.env).all()), "non-finite environment texels")


def validate_render_outputs(radiance, position, first_id, rays) -> None:
    """Post-wave output invariants (integrator.rs:272-280 guarantees)."""
    rad = _a(radiance)
    _check(bool(np.isfinite(rad).all()), "non-finite radiance escaped the sample guard")
    _check(bool((rad >= 0).all()), "negative radiance")
    _check(bool(np.isfinite(_a(position)).all()), "non-finite position buffer")
    _check(bool((_a(rays) >= 0).all()), "negative ray count")


def debug_render(scene_host, camera, width, height, spp=1, device="cuda", **kw):
    """Render one wave with scene and output validation; returns the film
    ``[H, W, 4]`` (rgb sum + sample count) as `integrator.wavefront.render`
    lays it out."""
    from path_tracer_tpu_torch.integrator.wavefront import render_sample

    validate_scene(scene_host)
    scene = scene_host.device(device)
    rad, pos, fid, rays = render_sample(
        scene,
        torch.as_tensor(camera.view_proj_inverse(), device=device),
        torch.as_tensor(camera.origin, device=device),
        0, width, height, spp=spp,
        mtypes=scene_host.active_mtypes, any_volumes=scene_host.has_volumes,
        has_lights=scene_host.has_lights, **kw,
    )
    validate_render_outputs(rad, pos, fid, rays)
    film = torch.cat([rad, torch.full((rad.shape[0], 1), float(spp), device=rad.device)], dim=1)
    return film.reshape(height, width, 4)


def _real_boxes(boxes: np.ndarray, what: str) -> np.ndarray:
    """``boxes [K, 6]`` (lo xyz | hi xyz): the mask of the real ones (a pad
    box starts at 1e30 or above: an inverted box or a far point box, never
    entered), each checked for min <= max."""
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    real = (lo < 1.0e30).all(axis=1)
    _check(bool((lo[real] <= hi[real]).all()), f"{what}: box min > max")
    return real


def _encloses(boxes: np.ndarray, rows: int, positions: np.ndarray, what: str) -> None:
    """Box ``i`` of ``boxes`` holds every vertex of triangles ``[i*rows,
    (i+1)*rows)`` of ``positions [T, 3, 3]`` (the table's row order)."""
    t = positions.shape[0]
    n = -(-t // rows)
    starts = np.arange(n) * rows
    lo = np.minimum.reduceat(positions.min(axis=1), starts, axis=0)
    hi = np.maximum.reduceat(positions.max(axis=1), starts, axis=0)
    _check(bool((boxes[:n, 0:3] <= lo).all() and (boxes[:n, 3:6] >= hi).all()),
           f"{what}: a box does not hold its rows' triangles")


def _nested(inner: np.ndarray, outer: np.ndarray, what: str) -> None:
    _check(bool((inner[:, 0:3] >= outer[:, 0:3]).all() and (inner[:, 3:6] <= outer[:, 3:6]).all()),
           f"{what}: a box is not inside its parent's")


def _octant_tables(eng: dict, what: str) -> int:
    """The walk-family gate tables ``cb_oct [8, 6, kq]`` / ``ord_oct [8,
    kq]``: the real columns a prefix, each with min <= max; every octant's
    order a permutation of the layout slots, and its boxes the layout's
    boxes in that order. Returns the number of real columns."""
    cb, ords = _a(eng["cb_oct"]), _a(eng["ord_oct"])
    real = _real_boxes(cb[0].T, f"{what} octant 0")
    kr = int(real.sum())
    _check(bool(real[:kr].all()), f"{what}: the real gate columns are not a prefix")
    for o in range(8):
        _real_boxes(cb[o].T, f"{what} octant {o}")
        _check(bool((np.sort(ords[o][:kr]) == np.arange(kr)).all()),
               f"{what} octant {o}: the visit order is not a permutation of the slots")
    layout = np.empty((6, kr), np.float32)
    layout[:, ords[0][:kr]] = cb[0][:, :kr]
    for o in range(8):
        _check(bool((cb[o][:, :kr] == layout[:, ords[o][:kr]]).all()),
               f"{what} octant {o}: its boxes are not the layout's in its order")
    return kr


def validate_walk_engine(eng: dict, num_tris: int, positions=None) -> None:
    """Structural invariants of one of the port's engine tables (host NumPy
    or device tensors): the walk (`trace.walk.pack_walk`), vwalk and iwalk
    (`trace.iwalk`, iwalk with its object boxes ``ocb``/``opb``) or the
    stream (`trace.dense_stream`: ``pab``/``cab``/``qab``). Values finite,
    boxes min <= max, orders permutations, indices in range, boxes nested in
    their parents'; with ``positions`` (the baked soup ``[num_tris, 3, 3]``
    the walk or stream indexes), each box holds its rows' triangles."""
    aux = _a(eng["aux"])
    _check(bool(np.isfinite(aux).all()), "non-finite aux rows")
    pos = None if positions is None else np.asarray(positions, np.float32)

    if "qab" in eng:  # the stream: rows in soup order, parts of equal stride
        from path_tracer_tpu_torch.trace import dense_stream

        pab, cab, qab = _a(eng["pab"]), _a(eng["cab"]), _a(eng["qab"])
        per = aux.shape[0] // pab.shape[0]
        _check(aux.shape[0] == pab.shape[0] * per and per % dense_stream.CH == 0,
               "stream: aux rows are not whole parts of whole chunks")
        for name, boxes, rows in (("pab", pab, per), ("cab", cab, dense_stream.CH),
                                  ("qab", qab, dense_stream.QH)):
            real = _real_boxes(boxes, f"stream {name}")
            n = -(-num_tris // rows)
            _check(bool(real[:n].all() and not real[n:].any()),
                   f"stream {name}: real boxes are not those of the soup's rows")
            if pos is not None:
                _encloses(boxes, rows, pos, f"stream {name}")
        nq, nc = -(-num_tris // dense_stream.QH), -(-num_tris // dense_stream.CH)
        g = np.arange(nq)
        _nested(qab[:nq], cab[g * dense_stream.QH // dense_stream.CH], "stream qab in cab")
        c = np.arange(nc)
        _nested(cab[:nc], pab[c * dense_stream.CH // per], "stream cab in pab")
        return

    from path_tracer_tpu_torch.trace.walk import CH_W

    kind = "vwalk" if "vinst" in eng else "iwalk" if "inst_c" in eng else "walk"
    kr = _octant_tables(eng, kind)
    om = _a(eng["origmap"])
    _check(bool((om >= 0).all() and (om < num_tris).all()), "origmap outside the triangle soup")
    k = aux.shape[0] // CH_W  # chunks of the row table
    if kind == "walk":
        _check(kr == k, "walk: a gate column for every chunk")
        if pos is not None:
            layout = np.empty((k, 6), np.float32)
            cb, ords = _a(eng["cb_oct"]), _a(eng["ord_oct"])
            layout[ords[0][:k]] = cb[0][:, :k].T
            live = (aux[:, 0:3] != 0.0).any(axis=1)  # pad rows are zero
            v = pos[om[live]]
            slot = np.flatnonzero(live) // CH_W
            _check(bool((layout[slot, None, 0:3] <= v).all() and (layout[slot, None, 3:6] >= v).all()),
                   "walk: a chunk box does not hold its rows' triangles")
    elif kind == "vwalk":
        ni = _a(eng["inst_f"]).shape[0]
        vi, vg = _a(eng["vinst"])[:kr], _a(eng["vglob"])[:kr]
        _check(bool((vi >= 0).all() and (vi < ni).all()), "vwalk: vinst out of range")
        _check(bool((vg >= 0).all() and (vg < k).all()), "vwalk: vglob outside the aux table")
    else:
        ic = _a(eng["inst_c"])
        _check(bool((ic >= 0).all() and (ic[:, 0] <= ic[:, 1]).all() and (ic[:, 1] <= k).all()),
               "iwalk: instance chunk ranges out of bounds")
        if "ocb" in eng:
            ocb, opb = _a(eng["ocb"]), _a(eng["opb"])
            part_c, inst_p = _a(eng["part_c"]), _a(eng["inst_p"])
            _check(ocb.shape[0] == k, "iwalk: an object chunk box for every chunk")
            _real_boxes(ocb, "iwalk ocb")
            _real_boxes(opb, "iwalk opb")
            _check(bool((part_c[:, 0] < part_c[:, 1]).all() and (part_c[1:, 0] == part_c[:-1, 1]).all()
                        and part_c[0, 0] == 0 and part_c[-1, 1] == k),
                   "iwalk: the parts do not tile the object chunks")
            _check(bool((inst_p >= 0).all() and (inst_p[:, 1] <= opb.shape[0]).all()),
                   "iwalk: instance part ranges out of bounds")
            part_of = np.repeat(np.arange(part_c.shape[0]), part_c[:, 1] - part_c[:, 0])
            real = (ocb[:, 0:3] <= ocb[:, 3:6]).all(axis=1)
            _nested(ocb[real], opb[part_of[real]], "iwalk ocb in opb")
