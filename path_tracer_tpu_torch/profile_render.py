"""Where the device time of one offline render goes, by torch.profiler.

    python -m path_tracer_tpu_torch.profile_render --scene mesh_scene \\
        --width 1024 --height 576 --spp 8 --out-dir profile_out

Runs a 1-spp warm-up render at the same film size (kernel build, caching
allocator), then the render once on its own, timed, and once under
torch.profiler (CPU and CUDA activities). Prints one JSON object:

* ``trace_s`` / ``mrays_per_s``: the render on its own (host clock ending
  in a synchronize), ``profiled_trace_s`` the same render under the
  profiler, which adds host time per op;
* ``steps``: bounce steps (one world any-hit launch per step: dense, walk,
  stream, vwalk or iwalk);
* ``device_busy_s``: the sum of the durations of every device event
  (kernels, copies, sets), all on one stream so none overlap;
* ``idle_share``: 1 - busy / trace, against the unprofiled trace (the
  profiled one only inflates it);
* ``kernels``: total device ms and launches of each intersection kernel
  (dense, walk, stream, vwalk and iwalk closest / any);
* ``kernels_per_step``: device kernels per bounce step, and ``top_ops`` the
  torch ops dispatched most often.

``--two-level`` builds the scene in two-level mode; ``PT_WALK=0`` in the
environment sends a baked soup above 16,384 triangles through the streamed
dense kernels and ``PT_VWALK=0`` a two-level scene through iwalk, as in the
CLI (``engine`` in the output names the world
engine). The profiler's tables go to
``<out-dir>/profile_<scene>[_two_level[_iwalk]|_stream].txt``.
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
from path_tracer_tpu_torch.integrator.wavefront import render_sample
from path_tracer_tpu_torch.scene.scene import env_engine, world_engine
from path_tracer_tpu_torch.trace import iwalk
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES

# profiler label -> the kernel's function name in csrc/
KERNELS = {
    "dense_closest": "closest_kernel", "dense_any": "any_kernel",
    "walk_closest": "walk_closest_kernel", "walk_any": "walk_any_kernel",
    "vwalk_closest": "vwalk_closest_kernel", "vwalk_any": "vwalk_any_kernel",
    "iwalk_closest": "iwalk_closest_kernel", "iwalk_any": "iwalk_any_kernel",
    "stream_closest": "stream_closest_kernel", "stream_any": "stream_any_kernel",
}
# one launch per bounce step
ANY_KEYS = ("any", "walk_any", "stream_any", "vwalk_any", "iwalk_any")


def _function(event_name: str) -> str:
    """``(anonymous namespace)::fn(args)`` or ``void ns::fn<...>(args)`` -> ``fn``."""
    head = event_name.replace("(anonymous namespace)", "").split("(")[0].split("<")[0]
    return re.split(r"[\s:]", head)[-1]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", default="mesh_scene", choices=SCENES)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--max-bounces", type=int, default=64)
    p.add_argument("--two-level", action="store_true", help="build the scene two-level")
    p.add_argument("--out-dir", default="profile_out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_render needs a CUDA card")
    dev = torch.device("cuda")

    sh, cam = getattr(scenes, args.scene)(aspect=args.width / args.height,
                                          two_level=args.two_level)
    engine = env_engine(sh.num_world_tris, args.two_level)
    scene = sh.device(dev, engine)
    if "twolevel" in scene:
        engine = iwalk.engine_name(scene["twolevel"]["iwalk"])
    else:
        engine = world_engine(sh.num_world_tris, engine)
    ndc = torch.as_tensor(cam.view_proj_inverse(), device=dev)
    org = torch.as_tensor(cam.origin, device=dev)

    def run(spp):
        out = render_sample(
            scene, ndc, org, 0, args.width, args.height, max_bounces=args.max_bounces,
            has_lights="light" in scene, spp=spp, mtypes=sh.active_mtypes,
            any_volumes=sh.has_volumes,
        )
        torch.cuda.synchronize()
        return out

    run(1)
    t0 = time.perf_counter()
    _, _, _, rays = run(args.spp)
    trace_s = time.perf_counter() - t0
    n_rays = float(rays[:, 0].sum())

    steps0 = sum(LAUNCHES[k] for k in ANY_KEYS)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(args.spp)
    profiled_s = time.perf_counter() - t0
    steps = sum(LAUNCHES[k] for k in ANY_KEYS) - steps0

    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    kernels = {}
    for label, fn in KERNELS.items():
        ev = [e for e in dev_events if _function(e.name) == fn]
        kernels[label] = {"ms": sum(e.time_range.elapsed_us() for e in ev) / 1e3, "launches": len(ev)}
    n_kernels = sum(1 for e in dev_events if "emcpy" not in e.name and "emset" not in e.name)
    ops = sorted(
        (e for e in prof.key_averages() if e.key.startswith("aten::")),
        key=lambda e: -e.count,
    )
    summary = {
        "scene": args.scene, "engine": engine, "width": args.width, "height": args.height,
        "spp": args.spp,
        "trace_s": trace_s, "mrays_per_s": n_rays / trace_s / 1e6,
        "profiled_trace_s": profiled_s, "steps": steps,
        "device_busy_s": busy_us / 1e6, "idle_share": 1.0 - busy_us / 1e6 / trace_s,
        "kernels": kernels, "device_kernels": n_kernels,
        "kernels_per_step": n_kernels / max(steps, 1),
        "top_ops": {e.key: e.count for e in ops[:12]},
    }
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    table_cpu = prof.key_averages().table(sort_by="count", row_limit=40)
    tag = ("_two_level" + ("_iwalk" if engine == "iwalk" else "") if args.two_level
           else "_stream" if engine == "stream" else "")
    (out_dir / f"profile_{args.scene}{tag}.txt").write_text(
        f"{json.dumps(summary, indent=1)}\n\n{table}\n\n{table_cpu}\n")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
