"""Command-line renderer: ``python -m path_tracer_tpu_torch.cli [...]``.

Port of ``path_tracer_tpu/cli.py``: a named scene or a JSON scene file
(`utils.config.load_scene_json`: OBJ models, a sky in any format
`scene.envmap.load_image` reads, paths relative to the working directory;
its camera, or the Cornell view at ``--fov`` if it has none), progressive
rendering in batches of up to 32 samples with optional checkpoints,
resumable renders, and the tonemapped image in the format of the extension
of ``--out`` (PNG, APNG, JPEG, TIFF, GIF, BMP, DIB, PPM, TGA or WebP, by Pillow's
extension table; checked before the scene is built: any other extension
raises the JAX package's ``ValueError``, but before the render rather than
after it). ``--device``
picks the torch device (default ``cuda``; with no card it raises rather
than falling back to the CPU). ``--two-level`` keeps shared object-space
tables plus instance transforms instead of baking instances to world space,
and traces through the two-level kernels (vwalk, or iwalk above vwalk's
cap), or above iwalk's caps through the gather engine
(``trace/twolevel.py``). ``PT_WALK=0`` in the environment switches the walk
off as in the JAX package: a baked soup above 16,384 triangles then goes
through the streamed dense kernels (``trace/dense_stream.py``);
``PT_VWALK=0`` sends a two-level scene through iwalk instead of vwalk, and
``PT_IWALK=0`` through the gather engine. The world engine is printed.
``--multichip`` renders the film tile-sharded across every visible card,
one process each (`parallel.mesh`): this process builds the host scene and
the CUDA libraries, then spawns a rank for each further card; with
``--device cpu`` it is a group of one gloo rank.

``--profile-dir`` records a ``torch.profiler`` trace of the render into
that directory (`utils.profiling.device_trace`). ``--retries`` retries a
batch that raised, after a backoff, up to that many times, saving the
checkpoint (with ``--checkpoint``) before each retry and before it gives
up; samples are pure functions of (lane, sample id), so a retried batch
adds what the failed one would have. The checkpoint comes from a host copy
of the film taken after each batch: after a sticky CUDA error (an illegal
address) the context is lost, the film on the card cannot be read and
every retry in this process would fail again, so the CLI saves that copy
and re-raises at once; ``--checkpoint`` in a new process resumes. With
``--multichip`` a rank's error raises (the group's collectives cannot
replay one rank's batch alone).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist

# the render path's CUDA sources, built before any rank of --multichip starts
RENDER_LIBS = ("dense_hit", "walk_hit", "iwalk_hit", "dense_stream")
SCENES = ("cornell_diffuse", "cornell_specular", "cornell_volume", "mesh_scene",
          "many_instance_scene", "dragon_scene", "env_sphere_scene")
RETRY_BACKOFF_S = 30.0  # seconds before retry n, times n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PyTorch + CUDA path tracer")
    p.add_argument("--scene", default="cornell_diffuse",
                   help=f"named scene ({', '.join(SCENES)}) or a .json scene file")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--max-bounces", type=int, default=64)
    p.add_argument("--no-nee", action="store_true", help="disable next-event estimation")
    p.add_argument("--fov", type=float, default=40.0,
                   help="field of view in degrees of a JSON scene without a camera")
    p.add_argument("--aperture", type=float, default=0.0,
                   help="thin-lens diameter in world units (0 = pinhole)")
    p.add_argument("--focus", type=float, default=0.0,
                   help="focus distance (0 = the scene's look-at distance)")
    p.add_argument("--out", default="render.png",
                   help="the image; its extension picks the format (png, jpg, tif, gif, bmp, ppm, tga, ...)")
    p.add_argument("--checkpoint", default=None, help="checkpoint .npz path (resume if exists)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--two-level", action="store_true",
                   help="keep shared object-space tables + instance transforms (two-level "
                        "traversal) instead of baking instances to world")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--multichip", action="store_true",
                   help="tile the film across every visible card, one process each (rank r on "
                        "cuda:r; with --device cpu one gloo rank)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the render (trace.json) into this directory")
    p.add_argument("--retries", type=int, default=2,
                   help="retries of a batch that raised (checkpoint + backoff); a lost CUDA "
                        "context is not retried")
    return p


def load_scene(args):
    """``(host scene, camera)`` of ``--scene``: a named scene, or a JSON
    scene file with its camera (or the Cornell view at ``--fov``)."""
    from path_tracer_tpu_torch import scenes

    aspect = args.width / args.height
    if not args.scene.endswith(".json"):
        return getattr(scenes, args.scene)(aspect=aspect, two_level=args.two_level)
    from path_tracer_tpu_torch.camera import Camera
    from path_tracer_tpu_torch.utils.config import load_camera_json, load_scene_json

    scene_host = load_scene_json(args.scene, two_level=args.two_level)
    cam = load_camera_json(args.scene, aspect) or Camera(
        (0.0, 277.5, 1300.0), (0.0, 277.5, 0.0), fov=args.fov, aspect_ratio=aspect)
    return scene_host, cam


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _context_lost(device: torch.device) -> bool:
    """Whether the CUDA context of ``device`` is lost (a sticky error: every
    later call fails as well)."""
    if device.type != "cuda":
        return False
    try:
        torch.cuda.synchronize(device)
    except RuntimeError:
        return True
    return False


def main(argv=None) -> dict:
    """Render; prints and returns a summary dict (``film`` is the final
    ``[H, W, 4]`` tensor, ``phases`` the host seconds of scene build,
    upload and trace, the rest are the printed numbers)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.scene.endswith(".json") and args.scene not in SCENES:
        parser.error(f"--scene {args.scene!r}: not a named scene ({', '.join(SCENES)}) "
                     "or a .json file")

    from path_tracer_tpu_torch.film import load_checkpoint
    from path_tracer_tpu_torch.utils.imageio import image_format
    from path_tracer_tpu_torch.utils.profiling import PhaseTimer

    image_format(args.out)  # raises for an extension save_png cannot write

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False")

    timers = PhaseTimer()
    with timers.phase("scene build"):
        scene_host, cam = load_scene(args)

    start, film = 0, None
    if args.checkpoint and os.path.exists(args.checkpoint):
        film, start = load_checkpoint(args.checkpoint, "cpu")
        print(f"resumed at sample {start}")
    if not args.multichip:
        return _render(args, scene_host, cam, device, timers, film, start)

    from path_tracer_tpu_torch.trace import cuda_lib

    world = 1
    if device.type == "cuda":
        cuda_lib.build(*RENDER_LIBS)
        world, device = torch.cuda.device_count(), torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        ctx = None
        if world > 1:
            import torch.multiprocessing as mp

            ctx = mp.start_processes(_spawned_rank,
                                     args=(world, store, args, scene_host, cam, start),
                                     nprocs=world - 1, join=False, start_method="spawn")
        try:
            res = _rank(0, world, store, args, scene_host, cam, device, timers, film, start)
        except BaseException:
            for proc in ctx.processes if ctx is not None else ():
                proc.terminate()
            raise
        while ctx is not None and not ctx.join():  # raises if a rank failed
            pass
        return res


def _spawned_rank(i, world, store, args, scene_host, cam, start) -> None:
    """Rank ``i + 1`` of ``--multichip``, a spawned process on ``cuda:i+1``."""
    from path_tracer_tpu_torch.utils.profiling import PhaseTimer

    _rank(i + 1, world, store, args, scene_host, cam, torch.device("cuda", i + 1), PhaseTimer(),
          None, start)


def _rank(rank, world, store, args, scene_host, cam, device, timers, film, start):
    """One rank of ``--multichip``: join the group through the ``FileStore``
    at ``store``, render, leave the group."""
    from path_tracer_tpu_torch.parallel.mesh import make_group

    make_group(device, store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        return _render(args, scene_host, cam, device, timers, film, start, sharded=True)
    finally:
        dist.destroy_process_group()


def _render(args, scene_host, cam, device, timers, film, start, sharded=False):
    """Upload, trace samples ``start`` to ``--spp`` into ``film`` in
    batches (each retried as ``--retries`` says), write the PNG (and
    checkpoints); ``sharded``: as one rank of the default group, each batch
    traced over this rank's slab and gathered, and only rank 0 prints and
    writes (the others return None)."""
    from path_tracer_tpu_torch.film import save_checkpoint, save_png
    from path_tracer_tpu_torch.integrator.wavefront import render_sample
    from path_tracer_tpu_torch.parallel.mesh import gather_lanes, render_sample_sharded
    from path_tracer_tpu_torch.scene.scene import env_engine, world_engine
    from path_tracer_tpu_torch.trace import dense_stream, iwalk
    from path_tracer_tpu_torch.trace.traversal import engine_name
    from path_tracer_tpu_torch.utils.profiling import RayRateMeter, device_trace

    lead = not sharded or dist.get_rank() == 0
    with timers.phase("upload"):
        engine = env_engine(scene_host.num_world_tris, args.two_level)
        scene = scene_host.device(device, engine)
        ndc = torch.as_tensor(cam.view_proj_inverse(), device=device)
        org = torch.as_tensor(cam.origin, device=device)
        _sync(device)
    if sharded:
        # every rank has started and uploaded before the trace clock runs
        dist.all_reduce(torch.zeros(1, device=device))
    if "twolevel" in scene:
        engine = engine_name(scene)
        eng = scene["twolevel"].get("iwalk") or scene["twolevel"]["gather"]
        what = (f"{eng['gates']} gate entries" if "iwalk" in scene["twolevel"]
                else f"{eng['inst_rows'].shape[0]} instances")
        line = (f"two-level engine: {engine} ({what}, "
                f"{iwalk.table_bytes(eng) / 2**20:.1f} MiB of tables)")
    else:
        engine = world_engine(scene_host.num_world_tris, engine)
        extra = ""
        if engine == "stream":
            eng = scene["tri"]["stream"]
            extra = (f" ({dense_stream.num_parts(eng)} parts, {eng['cab'].shape[0]} chunks, "
                     f"{dense_stream.table_bytes(eng) / 2**20:.1f} MiB of tables)")
        line = f"world engine: {engine}{extra}"
    if lead:
        print(line)

    if film is None:
        film = torch.zeros((args.height, args.width, 4), dtype=torch.float32, device=device)
    film = film.to(device)
    # the checkpoint's film, on the host: it survives a lost CUDA context
    saved = film.cpu() if lead and args.checkpoint else None
    aperture = args.aperture if args.aperture > 0 else cam.aperture
    focus = args.focus or cam.focus_distance
    lens = dict(aperture=aperture, focus=focus,
                cam_basis=torch.as_tensor(cam.matrix[:, :3], device=device)) if aperture > 0 else {}
    kw = dict(max_bounces=args.max_bounces, enable_nee=not args.no_nee,
              has_lights="light" in scene, mtypes=scene_host.active_mtypes,
              any_volumes=scene_host.has_volumes, **lens)
    batch = max(1, min(32, args.checkpoint_every or 32))

    def trace_batch(s, cur):
        if sharded:
            rad, rays = render_sample_sharded(scene, ndc, org, s, args.width, args.height,
                                              spp=cur, **kw)
            rows = gather_lanes(torch.cat([rad, rays], dim=1))
            rad, rays = rows[:, :3], rows[:, 3:]
        else:
            rad, _, _, rays = render_sample(scene, ndc, org, s, args.width, args.height,
                                            spp=cur, **kw)
        _sync(device)
        return rad, rays

    meter = RayRateMeter()
    with device_trace(args.profile_dir if lead else None):
        s = start
        while s < args.spp:
            cur = min(batch, args.spp - s)
            attempt = 0
            while True:
                try:
                    with meter.measure(0.0, 0):  # rays and samples added below
                        rad, rays = trace_batch(s, cur)
                    break
                except Exception as e:
                    attempt += 1
                    lost = _context_lost(device)
                    if sharded or lost or attempt > args.retries:
                        if saved is not None:
                            save_checkpoint(args.checkpoint, saved, s)
                            why = "the CUDA context is lost" if lost else f"{attempt} attempts"
                            print(f"device error after {why}; progress saved at sample {s}")
                        raise
                    if saved is not None:
                        save_checkpoint(args.checkpoint, saved, s)
                    print(f"device error ({type(e).__name__}), retry {attempt}/{args.retries}...")
                    time.sleep(RETRY_BACKOFF_S * attempt)
            meter.rays += float(rays[:, 0].sum())  # col 0 = all-queries count
            meter.samples += cur
            frame = torch.cat([rad, torch.full((rad.shape[0], 1), float(cur), device=device)], dim=1)
            film = film + frame.reshape(args.height, args.width, 4)
            s += cur
            if saved is not None:
                saved = film.cpu()
                if args.checkpoint_every:
                    save_checkpoint(args.checkpoint, saved, s)
    timers.phases["trace"] = meter.seconds
    if not lead:
        return None

    if args.checkpoint:
        save_checkpoint(args.checkpoint, saved, args.spp)
    save_png(args.out, film)
    summary = {
        "out": args.out, "spp": args.spp, "device": str(device), "engine": engine,
        "ranks": dist.get_world_size() if sharded else 1,
        "mrays_per_s": meter.mrays_per_s, "spp_per_s": meter.spp_per_s,
        "trace_s": meter.seconds,
    }
    print(json.dumps(summary))
    print(timers.report())
    return {**summary, "phases": timers.phases, "film": film}


if __name__ == "__main__":
    main()
