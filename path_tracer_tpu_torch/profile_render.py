"""Where the device time of one offline render goes, by torch.profiler.

    python -m path_tracer_tpu_torch.profile_render --scene mesh_scene \\
        --width 1024 --height 576 --spp 8 --out-dir profile_out
    python -m path_tracer_tpu_torch.profile_render --scene mesh_scene \\
        --pool on off --tile-lanes 0 65536 --out-dir profile_out

Renders through `render_film` (the film in tiles of ``--tile-lanes`` lanes,
0 = the whole film; pinned lanes or the pooled work queue, ``--pool on`` /
``off``; both default to the engine's `render_film` defaults). With several
values of either flag it runs every combination, in turn, in one process
on one uploaded scene. Each runs a 1-spp warm-up render at the same film
size (kernel build, caching allocator), then the render once on its own,
timed; after all are timed, the first combination once more under
torch.profiler (CPU and CUDA activities: reading a profile of ~300K
kernels takes the host minutes, so the others are timed only; and the
profiler slows the host for renders timed after it). Each prints one JSON
object:

* ``trace_s`` / ``mrays_per_s``: the render on its own (host clock ending
  in a synchronize), ``profiled_trace_s`` the same render under the
  profiler, which adds host time per op;
* ``steps``: bounce steps of the render (`wavefront.STEPS`), ``calls`` its
  `trace_lanes` calls (tiles x spp batches);
* (the profiled combination) ``device_busy_s``: the sum of the durations
  of every device event (kernels, copies, sets), all on one stream so
  none overlap;
* ``idle_share``: 1 - busy / trace, against the unprofiled trace (the
  profiled one only inflates it);
* ``kernels``: total device ms and launches of each intersection kernel
  (dense, walk, stream, vwalk and iwalk closest / any; the gather engine
  launches none);
* ``kernels_per_step``: device kernels per bounce step, and ``top_ops`` the
  torch ops dispatched most often;
* ``mean``: the film's mean radiance per sample.

``--two-level`` builds the scene in two-level mode; ``PT_WALK=0`` in the
environment sends a baked soup above 16,384 triangles through the streamed
dense kernels, ``PT_VWALK=0`` a two-level scene through iwalk and
``PT_IWALK=0`` through the gather engine, as in the CLI (``engine`` in the
output names the world engine). The profiler's tables go to
``<out-dir>/profile_<scene>[_two_level[_iwalk|_gather]|_stream]_<pool>_<tile>.txt``.
"""

from __future__ import annotations

import argparse
import json
import re
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from path_tracer_tpu_torch import scenes
from path_tracer_tpu_torch.cli import SCENES
from path_tracer_tpu_torch.integrator import wavefront
from path_tracer_tpu_torch.scene.scene import env_engine
from path_tracer_tpu_torch.trace.traversal import engine_name

# profiler label -> the kernel's function name in csrc/
KERNELS = {
    "dense_closest": "closest_kernel", "dense_any": "any_kernel",
    "walk_closest": "walk_closest_kernel", "walk_any": "walk_any_kernel",
    "vwalk_closest": "vwalk_closest_kernel", "vwalk_any": "vwalk_any_kernel",
    "iwalk_closest": "iwalk_closest_kernel", "iwalk_any": "iwalk_any_kernel",
    "stream_closest": "stream_closest_kernel", "stream_any": "stream_any_kernel",
}


def _function(event_name: str) -> str:
    """``(anonymous namespace)::fn(args)`` or ``void ns::fn<...>(args)`` -> ``fn``."""
    head = event_name.replace("(anonymous namespace)", "").split("(")[0].split("<")[0]
    return re.split(r"[\s:]", head)[-1]


def profiled(run, spp, trace_s, steps) -> dict:
    """``run(spp)`` under torch.profiler: device busy and idle share (against
    the unprofiled ``trace_s``), the intersection kernels' device ms and
    launches, kernels per bounce step, the most dispatched torch ops, and
    the profiler's ``tables``."""
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(spp)
    profiled_s = time.perf_counter() - t0
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    kernels = {}
    for label, fn in KERNELS.items():
        ev = [e for e in dev_events if _function(e.name) == fn]
        if ev:
            kernels[label] = {"ms": sum(e.time_range.elapsed_us() for e in ev) / 1e3,
                              "launches": len(ev)}
    n_kernels = sum(1 for e in dev_events if "emcpy" not in e.name and "emset" not in e.name)
    averages = prof.key_averages()
    ops = sorted((e for e in averages if e.key.startswith("aten::")), key=lambda e: -e.count)
    return {
        "profiled_trace_s": profiled_s, "device_busy_s": busy_us / 1e6,
        "idle_share": 1.0 - busy_us / 1e6 / trace_s, "kernels": kernels,
        "device_kernels": n_kernels, "kernels_per_step": n_kernels / max(steps, 1),
        "top_ops": {e.key: e.count for e in ops[:12]},
        "tables": averages.table(sort_by="self_device_time_total", row_limit=40),
    }


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", default="mesh_scene", choices=SCENES)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--max-bounces", type=int, default=64)
    p.add_argument("--two-level", action="store_true", help="build the scene two-level")
    p.add_argument("--pool", nargs="+", choices=("on", "off", "default"), default=["default"],
                   help="pooled work queue or pinned lanes (default: the engine's)")
    p.add_argument("--tile-lanes", nargs="+", type=int, default=[-1],
                   help="lanes per trace_lanes call, 0 = the whole film (default: the engine's)")
    p.add_argument("--out-dir", default="profile_out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_render needs a CUDA card")
    dev = torch.device("cuda")

    sh, cam = getattr(scenes, args.scene)(aspect=args.width / args.height,
                                          two_level=args.two_level)
    scene = sh.device(dev, env_engine(sh.num_world_tris, args.two_level))
    engine = engine_name(scene)
    ndc = torch.as_tensor(cam.view_proj_inverse(), device=dev)
    org = torch.as_tensor(cam.origin, device=dev)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    summaries, runs = [], []
    for pool_arg in args.pool:
        for tile_arg in args.tile_lanes:
            pool = None if pool_arg == "default" else pool_arg == "on"
            tile = None if tile_arg < 0 else tile_arg or args.width * args.height

            def run(spp, tile=tile, pool=pool):
                out = wavefront.render_film(
                    scene, ndc, org, 0, args.width, args.height, spp,
                    max_bounces=args.max_bounces, has_lights="light" in scene,
                    mtypes=sh.active_mtypes, any_volumes=sh.has_volumes, tile_lanes=tile, pool=pool,
                )
                torch.cuda.synchronize()
                return out

            run(1)
            wavefront.STEPS.update(bounce=0, calls=0)
            t0 = time.perf_counter()
            rad, rays = run(args.spp)
            trace_s = time.perf_counter() - t0
            used_tile = min(tile or wavefront.TILE_LANES or args.width * args.height,
                            args.width * args.height)
            summaries.append({
                "scene": args.scene, "engine": engine, "width": args.width, "height": args.height,
                "spp": args.spp, "pool": wavefront.POOL if pool is None else pool,
                "tile_lanes": used_tile, "trace_s": trace_s,
                "mrays_per_s": float(rays[0]) / trace_s / 1e6, "steps": wavefront.STEPS["bounce"],
                "calls": wavefront.STEPS["calls"], "mean": rad.mean().item() / args.spp,
            })
            runs.append(run)
    # the profile last: the profiler leaves the host slower for the renders
    # timed after it (1.4-1.8x on renders of the same work)
    first = summaries[0]
    first.update(profiled(runs[0], args.spp, first["trace_s"], first["steps"]))
    tables = first.pop("tables")
    tag = ("_two_level" + ("" if engine == "vwalk" else f"_{engine}") if args.two_level
           else "_stream" if engine == "stream" else "")
    name = f"profile_{args.scene}{tag}_{'pool' if first['pool'] else 'pinned'}_{first['tile_lanes']}"
    (out_dir / f"{name}.txt").write_text(f"{json.dumps(first, indent=1)}\n\n{tables}\n")
    for summary in summaries:
        print(json.dumps(summary), flush=True)
    return summaries


if __name__ == "__main__":
    main()
