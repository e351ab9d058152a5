"""Multi-card rendering: film-tile and spp sharding over ``torch.distributed``
(port of ``path_tracer_tpu/parallel/mesh.py``).

The render's one parallel axis, independent Monte Carlo pixels and samples,
maps onto one process per card in a process group (NCCL on cards, gloo on
the CPU) as data parallelism:

* **tile sharding**: each rank traces a contiguous slab of film lanes
  (BASELINE config 5: 1080p tiled across cards); the scene tables are
  replicated (each rank uploads its own copy) and each rank's film stays
  its own until a caller gathers it (`gather_lanes`);
* **spp sharding**: each rank traces the whole film at its own sample ids;
  the accumulators are summed with one ``all_reduce``.

Every RNG draw keys on the absolute film lane and sample id
(`wavefront.trace_lanes`), so both give the single-process render's
numbers per lane: the same bits where each lane's arithmetic does not
depend on the batch it rides in (the kernels' and the card's elementwise
ops), else within float reassociation; spp sharding sums the ranks'
samples in the collective's order.

One process per card, not one thread over several: every 1024x576 bounce
step is host-bound (thousands of kernel launches and one host read), so one
issuing thread would serialise the cards. Every function takes ``group``
(None: the default group) and takes its rank and world size from it; the
tensors it is given live on the rank's own device. The JAX package's one
SPMD program needs one static buffer size for all shards of a segmented
frame; separate processes do not, so each rank compacts and schedules its
own slab (`frame_segmented_sharded`).
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from path_tracer_tpu_torch.core.constants import MAX_BOUNCES
from path_tracer_tpu_torch.integrator import bsdf as bsdf_mod
from path_tracer_tpu_torch.integrator.wavefront import render_sample_segmented, trace_lanes


def shard_lanes(n: int, rank: int, world: int) -> range:
    """Rank ``rank``'s contiguous slab of ``n`` film lanes among ``world``
    ranks, ``[rank*chunk, (rank+1)*chunk)``; raises ``ValueError`` when
    ``n`` does not divide evenly (JAX ``mesh.py:65-67``)."""
    if n % world:
        raise ValueError(f"film lanes {n} not divisible by {world} ranks")
    chunk = n // world
    return range(rank * chunk, (rank + 1) * chunk)


def make_group(device=None, backend: str | None = None, store=None, rank: int | None = None,
               world_size: int | None = None, timeout: timedelta | None = None) -> torch.device:
    """Join the default process group, creating it if this process is not in
    one yet, and return this rank's device (JAX ``make_mesh:34``).

    Creating it takes ``store`` (a ``torch.distributed.Store`` the ranks
    share, e.g. a ``FileStore``), ``rank`` and ``world_size``, or without a
    store the environment a ``torchrun`` launch sets (``env://``).
    ``device``: this rank's device, by default ``cuda:<LOCAL_RANK>`` (else
    ``cuda:<rank>``); a CUDA device with no card raises. ``backend``:
    "nccl" on a card and "gloo" on the CPU unless named; gloo on a card is
    the caller's explicit choice (NCCL refuses two ranks on one card)."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_group: device {device} but torch.cuda.is_available() is False")
    if not dist.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        if store is not None:
            kw.update(store=store, rank=rank, world_size=world_size)
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"), **kw)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())))
        torch.cuda.set_device(device)
    return device


def gather_lanes(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's slab of ``x`` (equal shapes, lane-major), concatenated in
    rank order on every rank: the whole film (list-form ``all_gather``)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def _kinds(mtypes) -> tuple:
    """The material types to trace (None: all of them)."""
    return tuple(mtypes) if mtypes is not None else bsdf_mod.ALL_MTYPES


def _slab(width: int, height: int, group, device) -> torch.Tensor:
    r = shard_lanes(width * height, dist.get_rank(group), dist.get_world_size(group))
    return torch.arange(r.start, r.stop, dtype=torch.int64, device=device)


def render_sample_sharded(
    scene: dict,
    ndc_to_world: torch.Tensor,
    cam_origin: torch.Tensor,
    sample_id: int,
    width: int,
    height: int,
    group=None,
    max_bounces: int = MAX_BOUNCES,
    enable_nee: bool = True,
    has_lights: bool = True,
    spp: int = 1,
    mtypes=None,
    any_volumes: bool = True,
    aperture: float = 0.0,
    focus: float = 0.0,
    cam_basis=None,
):
    """``spp`` samples per pixel of this rank's slab of film lanes (JAX
    ``:41``), pinned. Returns the slab's ``(radiance [chunk, 3], rays
    [chunk, 2])``, lane-major; `gather_lanes` gives the whole film.
    ``width*height`` must divide evenly by the group's size."""
    lane = _slab(width, height, group, ndc_to_world.device)
    rad, _, _, rays = trace_lanes(
        scene, ndc_to_world, cam_origin, sample_id, lane, width, height,
        max_bounces=max_bounces, enable_nee=enable_nee, has_lights=has_lights, spp=spp,
        mtypes=_kinds(mtypes),
        any_volumes=any_volumes, aperture=aperture, focus=focus, cam_basis=cam_basis,
    )
    return rad, rays


def render_spp_sharded(
    scene: dict,
    ndc_to_world: torch.Tensor,
    cam_origin: torch.Tensor,
    base_sample: int,
    width: int,
    height: int,
    group=None,
    max_bounces: int = MAX_BOUNCES,
    enable_nee: bool = True,
    has_lights: bool = True,
    spp: int = 1,
    mtypes=None,
    any_volumes: bool = True,
    aperture: float = 0.0,
    focus: float = 0.0,
    cam_basis=None,
) -> torch.Tensor:
    """Each rank traces the whole film at ``spp`` samples from
    ``base_sample + rank * spp`` (JAX ``:98``); the ranks' ``[N, 4]``
    accumulators (rgb sum + count) are summed with one ``all_reduce``.
    Returns the sum, the same on every rank."""
    n = width * height
    lane = torch.arange(n, dtype=torch.int64, device=ndc_to_world.device)
    rad, _, _, _ = trace_lanes(
        scene, ndc_to_world, cam_origin, base_sample + dist.get_rank(group) * spp, lane,
        width, height, max_bounces=max_bounces, enable_nee=enable_nee, has_lights=has_lights,
        spp=spp, mtypes=_kinds(mtypes),
        any_volumes=any_volumes, aperture=aperture, focus=focus, cam_basis=cam_basis,
    )
    acc = torch.cat([rad, torch.full((n, 1), float(spp), dtype=rad.dtype, device=rad.device)], 1)
    dist.all_reduce(acc, group=group)
    return acc


def render_sharded(
    scene_host,
    camera,
    width: int,
    height: int,
    spp: int,
    group=None,
    max_bounces: int = MAX_BOUNCES,
    enable_nee: bool = True,
    device=None,
) -> torch.Tensor:
    """Progressive tile-sharded render (JAX ``:153``): one sample at a time
    through `render_sample_sharded`, each rank adding its slab's samples to
    its own film in sample order (the single-process per-lane sums), then
    one gather. Returns the film ``[H, W, 4]`` (rgb sum + count) on every
    rank. ``scene_host``: a host `Scene` (uploaded to ``device``, by
    default the rank's current card) or a scene tensor dict already
    there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("render_sharded: no device given and torch.cuda.is_available() "
                               "is False")
        device = torch.device("cuda", torch.cuda.current_device())
    scene = scene_host.device(device) if hasattr(scene_host, "device") else scene_host
    ndc = torch.as_tensor(camera.view_proj_inverse(), device=device)
    org = torch.as_tensor(camera.origin, device=device)
    chunk = len(shard_lanes(width * height, dist.get_rank(group), dist.get_world_size(group)))
    film = torch.zeros((chunk, 4), dtype=torch.float32, device=device)
    for s in range(spp):
        rad, _ = render_sample_sharded(
            scene, ndc, org, s, width, height, group, max_bounces=max_bounces,
            enable_nee=enable_nee, has_lights="light" in scene,
            mtypes=getattr(scene_host, "active_mtypes", None),
            any_volumes=getattr(scene_host, "has_volumes", True),
        )
        film = film + torch.cat([rad, torch.ones_like(rad[:, :1])], dim=1)
    return gather_lanes(film, group).reshape(height, width, 4)


def frame_segmented_sharded(
    scene: dict,
    ndc_to_world: torch.Tensor,
    cam_origin: torch.Tensor,
    sample_id: int,
    width: int,
    height: int,
    group=None,
    max_bounces: int = MAX_BOUNCES,
    enable_nee: bool = True,
    has_lights: bool = True,
    mtypes=None,
    any_volumes: bool = True,
    aperture: float = 0.0,
    focus: float = 0.0,
    cam_basis=None,
    predictor=None,
):
    """One interactive frame (1 spp, pinned) with dead-lane segmented
    compaction, tile-sharded (JAX ``:256-383``): each rank runs
    `wavefront.render_sample_segmented` over its own slab, its buffer sizes
    from ``_seg_caps(chunk)`` and its schedule its own (``predictor``: this
    rank's `SegmentPredictor`; nothing is read across ranks between
    segments). A lane's outputs do not depend on the schedule, so the
    gathered frame is the single-process frame.

    Returns ``(radiance [N,3], position [N,4], first_id [N] int64 holding
    uint32 bits, rays [N,2])`` gathered on every rank (two ``all_gather``
    calls)."""
    lane = _slab(width, height, group, ndc_to_world.device)
    rad, pos, fid, rays = render_sample_segmented(
        scene, ndc_to_world, cam_origin, sample_id, width, height,
        max_bounces=max_bounces, enable_nee=enable_nee, has_lights=has_lights,
        mtypes=_kinds(mtypes),
        any_volumes=any_volumes, aperture=aperture, focus=focus, cam_basis=cam_basis,
        predictor=predictor, lane=lane,
    )
    rows = gather_lanes(torch.cat([rad, pos, rays], dim=1), group)
    return rows[:, :3], rows[:, 3:7], gather_lanes(fid, group), rows[:, 7:]
