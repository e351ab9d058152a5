"""Command-line renderer: ``python -m path_tracer_tpu_torch.cli [...]``.

Port of ``path_tracer_tpu/cli.py``: a named scene, progressive rendering in
batches of up to 32 samples with optional checkpoints, resumable renders,
and a tonemapped PNG. ``--device`` picks the torch device (default ``cuda``;
with no card it raises rather than falling back to the CPU). ``--two-level``
keeps shared object-space tables plus instance transforms instead of baking
instances to world space, and traces through the two-level kernels (vwalk,
or iwalk above vwalk's cap), or above iwalk's caps through the gather
engine (``trace/twolevel.py``). ``PT_WALK=0`` in the environment switches
the walk off as in the JAX package: a baked soup above 16,384 triangles
then goes through the streamed dense kernels (``trace/dense_stream.py``);
``PT_VWALK=0`` sends a two-level scene through iwalk instead of vwalk, and
``PT_IWALK=0`` through the gather engine. The world engine is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

SCENES = ("cornell_diffuse", "cornell_specular", "cornell_volume", "mesh_scene",
          "many_instance_scene", "dragon_scene")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PyTorch + CUDA path tracer")
    p.add_argument("--scene", default="cornell_diffuse", choices=SCENES, help="named scene")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--max-bounces", type=int, default=64)
    p.add_argument("--no-nee", action="store_true", help="disable next-event estimation")
    p.add_argument("--aperture", type=float, default=0.0,
                   help="thin-lens diameter in world units (0 = pinhole)")
    p.add_argument("--focus", type=float, default=0.0,
                   help="focus distance (0 = the scene's look-at distance)")
    p.add_argument("--out", default="render.png")
    p.add_argument("--checkpoint", default=None, help="checkpoint .npz path (resume if exists)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--two-level", action="store_true",
                   help="keep shared object-space tables + instance transforms (two-level "
                        "traversal) instead of baking instances to world")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Render; prints and returns a summary dict (``film`` is the final
    ``[H, W, 4]`` tensor, ``phases`` the host seconds of scene build,
    upload and trace, the rest are the printed numbers)."""
    args = build_parser().parse_args(argv)

    from path_tracer_tpu_torch import scenes
    from path_tracer_tpu_torch.film import load_checkpoint, save_checkpoint, save_png
    from path_tracer_tpu_torch.integrator.wavefront import render_sample
    from path_tracer_tpu_torch.scene.scene import env_engine, world_engine
    from path_tracer_tpu_torch.trace import dense_stream, iwalk
    from path_tracer_tpu_torch.trace.traversal import engine_name

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False")

    phases = {}
    t0 = time.perf_counter()
    scene_host, cam = getattr(scenes, args.scene)(aspect=args.width / args.height,
                                                  two_level=args.two_level)
    phases["scene build"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    engine = env_engine(scene_host.num_world_tris, args.two_level)
    scene = scene_host.device(device, engine)
    ndc = torch.as_tensor(cam.view_proj_inverse(), device=device)
    org = torch.as_tensor(cam.origin, device=device)
    _sync(device)
    phases["upload"] = time.perf_counter() - t0
    if "twolevel" in scene:
        engine = engine_name(scene)
        eng = scene["twolevel"].get("iwalk") or scene["twolevel"]["gather"]
        what = (f"{eng['gates']} gate entries" if "iwalk" in scene["twolevel"]
                else f"{eng['inst_rows'].shape[0]} instances")
        print(f"two-level engine: {engine} ({what}, "
              f"{iwalk.table_bytes(eng) / 2**20:.1f} MiB of tables)")
    else:
        engine = world_engine(scene_host.num_world_tris, engine)
        extra = ""
        if engine == "stream":
            eng = scene["tri"]["stream"]
            extra = (f" ({dense_stream.num_parts(eng)} parts, {eng['cab'].shape[0]} chunks, "
                     f"{dense_stream.table_bytes(eng) / 2**20:.1f} MiB of tables)")
        print(f"world engine: {engine}{extra}")

    start = 0
    film = torch.zeros((args.height, args.width, 4), dtype=torch.float32, device=device)
    if args.checkpoint and os.path.exists(args.checkpoint):
        film, start = load_checkpoint(args.checkpoint, device)
        print(f"resumed at sample {start}")

    aperture = args.aperture if args.aperture > 0 else cam.aperture
    focus = args.focus or cam.focus_distance
    lens = dict(aperture=aperture, focus=focus,
                cam_basis=torch.as_tensor(cam.matrix[:, :3], device=device)) if aperture > 0 else {}
    batch = max(1, min(32, args.checkpoint_every or 32))

    rays_total = 0.0
    samples = 0
    trace_s = 0.0
    s = start
    while s < args.spp:
        cur = min(batch, args.spp - s)
        t0 = time.perf_counter()
        rad, _, _, rays = render_sample(
            scene, ndc, org, s, args.width, args.height,
            max_bounces=args.max_bounces, enable_nee=not args.no_nee,
            has_lights="light" in scene, spp=cur, mtypes=scene_host.active_mtypes,
            any_volumes=scene_host.has_volumes, **lens,
        )
        _sync(device)
        trace_s += time.perf_counter() - t0
        rays_total += float(rays[:, 0].sum())  # col 0 = all-queries count
        samples += cur
        frame = torch.cat([rad, torch.full((rad.shape[0], 1), float(cur), device=device)], dim=1)
        film = film + frame.reshape(args.height, args.width, 4)
        s += cur
        if args.checkpoint and args.checkpoint_every:
            save_checkpoint(args.checkpoint, film, s)
    phases["trace"] = trace_s

    if args.checkpoint:
        save_checkpoint(args.checkpoint, film, args.spp)
    save_png(args.out, film)
    summary = {
        "out": args.out, "spp": args.spp, "device": str(device), "engine": engine,
        "mrays_per_s": rays_total / trace_s / 1e6 if trace_s > 0 else 0.0,
        "spp_per_s": samples / trace_s if trace_s > 0 else 0.0,
        "trace_s": trace_s,
    }
    print(json.dumps(summary))
    print("  ".join(f"{k}: {v:.3f} s" for k, v in phases.items()))
    return {**summary, "phases": phases, "film": film}


if __name__ == "__main__":
    main()
