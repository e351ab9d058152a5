"""End-to-end smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --parent <csrc directory of a parent commit> [<another> ...]

Phases (any failure raises and the script exits non-zero without the final
``ok`` line):

1. environment: torch, CUDA, the card's name and power limit;
2. build every kernel source (``dense_hit.cu``, ``walk_hit.cu``, and those
   of phases 10 and 16) from ``path_tracer_tpu_torch/csrc``, one nvcc
   each, started together, and beside them the native host builder
   (``csrc/pt_native.cpp``, g++), which must build: every host scene
   build of the smoke takes it; print ptxas registers and spills;
3. dense kernels against their plain torch versions on ``mesh_scene``'s
   world table (5,132 rows, 41 chunks; 65,536 camera + 65,536 random rays,
   with inf / 0 / NaN lanes), plus a float64 run of the plain closest hit
   as a precision oracle; the chunk cull's edge cases for both queries
   (axis-parallel rays, rays from and along chunk box faces, limits one ulp
   either side of a closest t) and the closest hit on the tie set
   (``dense_cuda.tie_soup``: one triangle in two chunks and twice within
   one); then both compared again, and timed, at the render's shapes: the
   world query over 589,824 camera rays and 589,824 bounce rays in random
   directions from the camera hits, the lights pretest over 589,824 rays,
   the any-hit over 1,179,648 shadow rays, with chunks entered per lane,
   chunks staged per block, entering lanes per staged chunk and the tested
   against the needed pairs; with ``--parent``, each of these queries
   beside the kernels built from each directory given (other, this, this,
   other);
4. the offline render of ``mesh_scene`` at 1024x576, 8 spp, 64 bounces
   through ``path_tracer_tpu_torch.cli``, with the kernels' launch counts;
5. ``cornell_specular`` at 32x32, 2 spp rendered on the CPU (plain
   versions) and on the card (kernels): image means within 1%;
6. walk kernels against their plain versions on the full ``dragon_scene``
   world table (884,748 tris; 32,768 camera + 32,768 random rays with inf /
   0 / NaN lanes), plus the float64 plain closest hit on 4,096 of them;
7. the walk kernels' segment-cull edge cases against the plain versions,
   both queries (axis-parallel rays, rays from and along chunk box faces,
   limits one ulp either side of a closest t), and the closest hit on the
   tie set (``walk.tie_soup``: one triangle in two chunks and twice within
   one, every ray's closest hit); the walk kernels timed at the render's
   shapes (589,824 camera rays, 589,824 bounce rays in random directions
   from the camera hits, 1,179,648 shadow rays toward the light), compared
   with the plain versions on 16,384 rays of each, with gate survivors
   admitted and skipped, chunks staged per block, entering lanes per staged
   chunk and the tested against the needed pairs; with ``--parent``, each
   shape beside the kernel built from each directory given, a parent
   commit's csrc or a variant of it (other, this, this, other);
8. the offline render of ``dragon_scene`` at 1024x576, 2 spp, 64 bounces
   through the CLI, with bounce steps and launch counts (the CLI gets phase
   6's host scene, built once: phases 8 and 18 print no build time of
   their own);
9. ``dragon_scene(nu=96, nv=64, env_h=64)`` (24,588 tris, the walk engine)
   at 32x32, 2 spp on the CPU and on the card: image means within 1%;
10. (with phase 2) ``iwalk_hit.cu``, built in the same call, its ptxas lines;
11. the two-level kernels against their plain versions on the full
    two-level dragon tables (made from phase 6's models; 10,070 virtual
    chunks, 5,037 object chunks in 162 parts): vwalk on 32,768 camera +
    32,768 random rays with inf / 0 / NaN lanes, the float64 plain version
    on 4,096 of them, iwalk on 4,096, both any-hits; iwalk's kernels against
    vwalk's on every ray (t and flags equal); and the vwalk public query
    against the baked walk's on the same rays (hit flags, t);
12. the two-level kernels timed at the render's shapes: vwalk and iwalk on
    the same rays of the two-level dragon (589,824 camera, 589,824 bounce,
    1,179,648 shadow rays; with ``--parent``, both engines' queries beside
    the parent's as in phase 7), and iwalk
    on ``many_instance_scene`` at 1920x1080 (2,073,600 camera and bounce
    rays, 4,147,200 shadow rays; with ``--parent``, both queries beside the
    parent's at every shape), each compared with its plain version on
    16,384 rays, with gate entries admitted, chunks staged per block, lanes
    listed per staged chunk, the tested against the needed pairs, and for
    iwalk the instances, parts and chunks entered per valid lane; then
    both culls' edge cases for both queries as in phase 7 (iwalk's face
    rays from its object chunk boxes, through an instance), and the tie
    sets: vwalk's closest hit on two coincident instances of the tie soup
    with its triangle held twice, iwalk's closest and any hit on two
    coincident instances with the triangle in two object chunks, twice in
    one (`iwalk.tie_tables`);
13. ``dragon_scene --two-level`` through the CLI at 1024x576, 2 spp: host
    build, engine table bytes against the baked walk's, trace, bounce
    steps, launch counts (vwalk > 0, walk 0);
14. ``many_instance_scene --two-level`` through the CLI at 1920x1080, 4 spp
    (vwalk), then ``PT_VWALK=0`` the same through the CLI at 1 spp (iwalk
    launches > 0, vwalk 0), then ``PT_VWALK=0 dragon_scene --two-level``
    through the CLI at 1024x576, 1 spp (iwalk launches > 0, vwalk 0) and
    the same sample through vwalk in process: image means within 1%;
15. ``many_instance_scene(grid=3, subdivisions=1)`` two-level at 32x32,
    4 spp: CPU against the card for both engines, and two-level against
    baked on the card: image means within 1%;
16. (with phase 2) ``dense_stream.cu`` and ``gather_probe.cu``, built in the
    same call, their ptxas lines; (after phase 9) the streamed dense
    kernels against their plain versions on the full dragon table packed
    for the stream (55 parts, 1,760 chunks, 7,040 groups; 16,384 camera +
    16,384 random rays with inf / 0 / NaN lanes), the float64 plain closest
    hit on 4,096 of them, the cull's edge cases for both queries
    (axis-parallel rays, rays from and along part, chunk and group box
    faces, limits one ulp either side of a closest t), the tie set
    (``dense_stream.tie_soup``: one triangle in two parts and twice within
    one group) for both queries, and the stream's public query against the
    walk's on the same rays (hit flags equal; a different winner only at
    the same t);
17. the stream kernels timed at the render's shapes in the integrator's
    pixel order (589,824 camera, 589,824 bounce, 1,179,648 shadow rays),
    each against its plain version on 16,384 rays of whole blocks, with the
    cull's counters (parts, chunks and groups entered per lane, groups
    staged per block, lanes listed per staged group) and the tested
    against the needed pairs over 512-row chunks and over 128-row groups,
    beside the walk's public query on the same rays (its sort included):
    the stream-vs-walk A/B, and on the shadow rays the two any-hit kernels'
    own times; with ``--parent``, each shape beside the stream kernels
    built from each directory given (other, this, this, other);
18. ``PT_WALK=0`` dragon_scene through the CLI at 1024x576, 1 spp, 64
    bounces (stream launches > 0, walk 0), then the same render through the
    walk in process (sample 0, the same seeds): image means within 1%;
19. ``dragon_scene(nu=96, nv=64, env_h=64)`` with ``engine="stream"`` at
    32x32, 1 spp, 16 bounces on the CPU and on the card: image means within
    1%;
20. the gather probes (``python -m path_tracer_tpu_torch.probes.gather``):
    row gather and in-tile gather kernels equal to their plain and library
    versions, timed, each kernel and its library call as the device-only
    median of 200 single launches each, alternating, queued behind a sleep
    (``ms``, ``library_ms``), as the issue-inclusive median of 200 single
    launches on an idle card (``issue_ms``, ``library_issue_ms``) and by the
    host's issue time per call, beside the launch floor (an empty kernel's
    device-only median, ``floor_ms``); with ``--parent``, both probe
    kernels at every probe shape beside the parent's, device-only, in turns
    (other, this, this, other, ...), outputs equal;
21. the Cornell shell with an emissive ``icosphere(subdivisions=5)``: 20,482
    light triangles, above the dense engine's 16,384, so the lights take the
    stack BVH (torch ops): 32x32, 2 spp on the CPU and on the card, image
    means within 1%; then the stack BVH's closest and any hit on the card
    over 65,536 rays of that light table, timed.

22. ``render_film`` (``integrator/wavefront.py``) on ``mesh_scene`` at
    1024x576, 8 spp (after phase 4), the walk ``dragon_scene`` at 1024x576,
    2 spp (after phase 8) and ``many_instance_scene --two-level`` at
    1920x1080, 4 spp (vwalk; after phase 14): ``render_sample``, pinned
    ``render_film`` and pooled ``render_film`` twice at the engine's
    default tile, each with trace seconds, Mrays/s and bounce steps
    (``wavefront.STEPS``); pinned bit-equal to ``render_sample`` (radiance
    and ray totals), the two pooled renders bit-equal (the deterministic
    flush), pooled means within 1% of pinned with equal ray totals; then
    the tile sweep: one more tile size (262,144 lanes; 1,048,576 at
    1920x1080), pinned (bit-equal to ``render_sample``: full tiles and a
    remainder tile) and pooled;
23. the two-level gather engine (``trace/twolevel.py``, torch ops) on
    ``many_instance_scene`` two-level: closest and any hit against iwalk's
    kernels on 65,536 rays (hit flags, t on every common hit, a different
    instance only at the same t, any-hit flags), the ms per query of both;
    then ``PT_IWALK=0`` through the CLI at 256x144, 1 spp (no two-level
    kernel launches), its mean within 1% of the same render through vwalk.
24. the interactive frame (``path_tracer_tpu_torch/interactive``): every
    TAA stage at 1024x576 on the card against the CPU on the same
    numpy-seeded inputs (float stages within rtol 1e-5, atol 1e-6; ids
    equal; ``display_frame_u8`` equal but within 1e-3 of a .5 step); then
    ``render_sample_segmented`` bit-equal to ``render_sample`` (radiance,
    position, first id, rays) on ``cornell_specular`` and
    ``cornell_volume`` at 1024x576, 64 bounces, samples 0 and 3,
    count-driven and over 4 frames of one predictor, with steps, segments,
    host reads and overflows; then ``InteractiveRenderer`` sessions at
    1024x576 on ``cornell_specular``, ``cornell_volume`` and
    ``mesh_scene``, static (one warm frame, 8 timed) and moving (the JAX
    fps bench's orbit; one warm, 3 timed), each frame ending in
    ``display(as_uint8=True)``: frames/s, ms per frame split into trace,
    TAA and display, steps, segments and host reads per frame, dense
    closest / any launches of every frame (each > 0) and the predictor's
    overflows; then ``cornell_specular`` static, 2 frames each after a warm
    frame, monolithic (``PT_INTERACTIVE_SEG=0``) and count-driven beside
    the default's run (one reading, not an A/B: `phase_schedule_ab` runs
    the three schedules in alternating rounds, called on its own).
25. multi-card rendering (``path_tracer_tpu_torch/parallel/mesh.py``):
    one-process references on the card (``render_sample``); ``cli
    --multichip`` at 1024x576, 1 spp on mesh_scene (a rank per visible
    card) against them; (a) a group of one over NCCL in this process:
    tile-sharded mesh_scene 1 spp and spp-sharded 2 spp against one and
    two sequential samples; (b) two spawned ranks on this card over gloo
    (NCCL refuses two ranks on one card): mesh_scene tile 1 spp and spp
    2 x 1 spp, ``many_instance_scene --two-level`` tile at 1920x1080 (config
    5's film, vwalk), 2 sharded frames of ``cornell_specular`` (the
    second predicted) and a 2-frame ``InteractiveRenderer(group=...)``
    session on it (a camera move on rank 0 alone before the second frame)
    against one process's session; tile, frames and the session's
    accumulation within rtol 1e-5, atol 1e-6 (the lanes or pixels that
    differ at all printed; ids equal), spp within rtol 1e-6;
    each rank's trace seconds, all_gather and all_reduce ms, the rank skew
    and the launches (each > 0) beside the one-process seconds of the same
    samples; (c) with two cards or more, (b) over NCCL with a rank on every
    card, else a line says it did not run.

26. the scene inputs and the host runtime: ``native.available()`` (the
    native host builder, built with g++ at its first use); the JSON scene
    ``assets/asset_scene.json`` (the Cornell walls and light, two instances
    of ``assets/knot.obj``, ``assets/sky.png``; 13,832 world tris, the dense
    kernels) and ``env_sphere_scene`` (1,280 tris, no lights: no any-hit
    launch) through the CLI at 1024x576, 8 spp, with their launch counts;
    phase 3's checks on the asset scene's world table (13,832 rows, 109
    chunks: the chunk mask's words 2-3 run), every ray set, edge case and
    render shape, kernel against plain, timed; both scenes at 32x32, 2 spp
    on the CPU and on the card, image means within 1%; the host build
    (``Scene``) of the asset scene with the native builder and with the
    NumPy one, and of ``dragon_scene`` with the native one; the disk cache's miss (generate and write) against
    its hit for the dragon's knot and sky; the image codecs (no Pillow on
    the card's machine): ``assets/sky.jpg`` (baseline 4:2:0) and
    ``assets/sky_progressive.jpg`` (progressive 4:4:4, restart intervals)
    decoded through the native library to the SHA-256 digests of Pillow's
    decode in ``assets/jpeg_digests.json``, ``assets/asset_scene_jpeg.json``
    (the asset scene under ``sky.jpg``) through the CLI at 1024x576, 8 spp
    to a ``.jpg`` (dense closest and any launched; bounce steps, trace
    seconds, launches), that file decoded against the film's tonemapped
    bytes (PSNR >= 30 dB), the scene at 32x32, 2 spp on the CPU and on the
    card, and the dragon's 2048x4096 sky encoded at quality 90 and decoded
    (seconds, the decode under 5 s, PSNR); the other raster formats: the
    committed TIFF (LZW with predictor; 16-bit tiled), GIF, run-length TGA
    and BMP, ASCII PPM and CMYK and 4:1:1 JPEG files decoded to the digests
    of Pillow's decode in ``assets/format_digests.json``,
    ``assets/asset_scene_tiff.json`` (the asset scene under ``sky.tif``,
    ``sky.png``'s pixels) and ``asset_scene.json`` through the CLI at
    1024x576, 2 spp (bounce steps, trace seconds, launches), 0 pixels of
    their films differing, the TIFF-sky film written to ``.tif``, ``.bmp``,
    ``.dib``, ``.ppm``, ``.tga``, ``.gif`` and ``.apng`` and decoded back
    (the lossless ones equal to its tonemapped bytes, the GIF's PSNR held to
    ``GIF_PSNR_MIN``), and the 2048x4096 sky through the GIF, TIFF and BMP
    writers and readers (seconds, each decode under 5 s); WebP: the
    committed lossless sky, lossy, ``VP8X`` + ``ALPH`` and animated files
    decoded to the digests in ``assets/webp_digests.json``,
    ``assets/asset_scene_webp.json`` (the asset scene under ``sky.webp``)
    rendered beside the other two with 0 pixels of its film differing, the
    film to ``.webp`` and back (PSNR held to ``WEBP_PSNR_MIN``), the
    2048x4096 sky through the WebP writer and reader (the decode under
    5 s); and
    ``--profile-dir`` on a 64x64 render: the trace's events and kernels.

Phases run in the order 1-4, 22, 5-8, 22, 9, 16-21, 10-14, 22, 23, 15, 24, 25, 26.
Each render's launch counts
(and the probes', and each frame's) are set to 0 just before it and read
just after. The
dense closest hit is held to winners and every output column equal to the
plain version on every ray of every set and shape, the walk, vwalk, iwalk
and stream closest hits to winners (and instances) and t (their culls are
exact and their arithmetic the plain versions'); every any-hit to every
flag.
``bound_ms`` is the least time the card could take for the same work: the
larger of the bytes the query must move over 3.35 TB/s and its float32
operations over 67 TFLOP/s (H100 SXM data sheet), counting the ray x
triangle pairs these rays need. For a dense or walk query (a dense
table's chunks: its runs of 128 rows, ``cab``) the need is set by each
ray's own slab test against every chunk box, not by the kernel's block
gate: a live closest-hit ray tests the real (not pad)
triangles of every chunk it enters before its own closest hit (or its
limit on a miss); a live shadow ray with an occluder tests the real
triangles of the one chunk that holds its closest occluder, one without
tests those of every chunk its segment enters. The box tests are not
charged (a tree over the boxes needs a few per ray). A two-level query
needs the same pairs counted against the boxes its engine culls: vwalk's
virtual chunks' world boxes; iwalk's (instance, object chunk) entries,
each entered when the ray passes the kernel's own test of the widened
instance box and then, on its object-space ray, of the part and chunk
boxes (`iwalk.entry_enters`); plus 30 operations per (ray, instance)
whose chunks it enters (the object-space transform); its bytes count each
needed OBJECT chunk's planes once, however many instances share it. No one
PyTorch call computes these queries, so ``library_ms`` is null. A stream
query's need is counted as a walk query's, over the stream's groups of 128
triangles (``qab``, the boxes its kernels cull and stage: the bound's
need) and, printed beside it as ``needed_pairs_512``, over its chunks of
512 (``cab``, the need of the bounds before the groups). A probe's bound is its bytes: every row or
entry read once and written once, with the indices; ``library_ms`` is
``torch.index_select`` (row gather) or ``torch.gather`` (in-tile gather),
each device-only like ``ms``.

The last lines are the card line, one JSON object describing each kernel,
and ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "path_tracer_tpu_torch" / "_build"  # gitignored
WIDTH, HEIGHT, SPP, MAX_BOUNCES = 1024, 576, 8, 64
DRAGON_SPP = 2  # the baked and two-level dragon renders (4 until the stream phases came)
CAMERA_GRID = 256  # 256 x 256 = 65,536 camera rays
N_RANDOM = 65536
WINNER_AGREE = 0.9999  # iwalk vs vwalk winners: one function, ties in other orders
ORACLE_AGREE = 0.999  # kernel vs the float64 plain version
MEAN_TOL = 0.01  # cross-backend image means
PLAIN_RAYS = 16384  # walk plain versions at the render's shapes
PEAK_FLOPS = 67e12  # H100 SXM float32, outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# float32 operations per ray x triangle pair, counted from the sources
FLOPS = {"closest": 47, "any": 46, "walk_closest": 42, "walk_any": 41,
         "vwalk_closest": 42, "vwalk_any": 41, "iwalk_closest": 42, "iwalk_any": 41,
         "stream_closest": 47, "stream_any": 46}
XFORM_FLOPS = 30  # the object-space transform of one ray (iwalk_hit.cu obj_ray)
DEVICE = "cuda"
DENSE_SRC = "path_tracer_tpu_torch/csrc/dense_hit.cu"
WALK_SRC = "path_tracer_tpu_torch/csrc/walk_hit.cu"
IWALK_SRC = "path_tracer_tpu_torch/csrc/iwalk_hit.cu"
STREAM_SRC = "path_tracer_tpu_torch/csrc/dense_stream.cu"
PROBE_SRC = "path_tracer_tpu_torch/csrc/gather_probe.cu"
REPLACES = {
    "closest": "path_tracer_tpu/trace/dense_pallas.py:391",
    "any": "path_tracer_tpu/trace/dense_pallas.py:503",
    "walk_closest": "path_tracer_tpu/trace/walk.py:821",
    "walk_any": "path_tracer_tpu/trace/walk.py:919",
    "vwalk_closest": "path_tracer_tpu/trace/iwalk.py:1042",
    "vwalk_any": "path_tracer_tpu/trace/iwalk.py:1116",
    "iwalk_closest": "path_tracer_tpu/trace/iwalk.py:340",
    "iwalk_any": "path_tracer_tpu/trace/iwalk.py:422",
    "stream_closest": "path_tracer_tpu/trace/dense_stream.py:269",
    "stream_any": "path_tracer_tpu/trace/dense_stream.py:391",
    "row_gather": "benches/pallas_gather_probe.py:39",
    "tile_gather": "benches/pallas_lane_gather_probe.py:45",
}
MANY_W, MANY_H, MANY_SPP = 1920, 1080, 4  # BASELINE config 5's film
FILM_TILES = (262144,)  # phase 22's tile sweep at 1024x576 (589,824 lanes), beside the whole film
MANY_FILM_TILES = (1048576,)  # and at 1920x1080 (2,073,600 lanes)
TWO_CAMERA, TWO_RANDOM = (256, 128), 32768  # phase 11's camera film and random rays
SUBSET = 4096  # the float64 and iwalk subsets of the dragon's rays
T_REL = 1e-5  # two-level vs baked t
BAKED_AGREE = 0.999  # two-level vs baked hit flags and t
STREAM_CAMERA, STREAM_RANDOM = (128, 128), 16384  # phase 16's camera film and random rays


def check(ok, what) -> None:
    """Fail the run (an explicit raise: ``assert`` vanishes under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int):
    """(mean device time of ``fn()`` over ``reps`` calls by CUDA events, the
    output of the one warm-up call before them)."""
    out = fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def time_plain(fn, rows):
    """(device time of one ``fn(rows)`` call by CUDA events, its output),
    after a warm-up call on the first block of ``rows``: a plain version
    runs once on all the rows it is compared on, not twice as
    ``time_ms(fn, 1)`` would (at 16,384 rays the walk, two-level and stream
    plain versions take 8-15 s a call)."""
    fn(rows[:128])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn(rows)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def bound_ms(flops: float, nbytes: float):
    """(least time in ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def camera_rays(cam, w, h, dev):
    """Pixel-centre camera rays of a w x h film."""
    from path_tracer_tpu_torch.camera import ray_directions

    ndc = torch.as_tensor(cam.view_proj_inverse(), device=dev)
    org = torch.as_tensor(cam.origin, device=dev)
    ys, xs = torch.meshgrid(
        torch.arange(h, device=dev, dtype=torch.float32),
        torch.arange(w, device=dev, dtype=torch.float32), indexing="ij",
    )
    d = ray_directions(ndc, org, ((xs + 0.5) / w).reshape(-1), ((ys + 0.5) / h).reshape(-1))
    return org.expand(d.shape[0], 3).contiguous(), d.contiguous()


def unit_rows(rng, n, dev):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return torch.as_tensor(v / np.linalg.norm(v, axis=1, keepdims=True), device=dev)


def edge_lanes(rng, o, d, tl, dev):
    """Mark lanes of a ray set: 512 with t_limit 0, 512 with a finite limit,
    64 NaN origins, 64 NaN directions. Returns the permutation used."""
    lanes = rng.permutation(o.shape[0])
    pick = lambda a, b: torch.as_tensor(lanes[a:b], device=dev)  # noqa: E731
    tl[pick(0, 512)] = 0.0
    tl[pick(512, 1024)] = torch.as_tensor(rng.uniform(50.0, 800.0, 512).astype(np.float32), device=dev)
    o[pick(1024, 1088)] = math.nan
    d[pick(1088, 1152)] = math.nan
    return lanes


def light_targets(rng, scene, n, dev):
    """n random points on the scene's light triangles."""
    lp = scene["light"]["positions_flat"]
    uv = torch.as_tensor(rng.uniform(0.0, 0.5, (n, 2)).astype(np.float32), device=dev)
    rows = lp.index_select(0, torch.as_tensor(rng.integers(0, lp.shape[0], n), device=dev))
    return (rows[:, 0:3] * (1 - uv[:, :1] - uv[:, 1:]) + rows[:, 3:6] * uv[:, :1]
            + rows[:, 6:9] * uv[:, 1:])


# --- the dense kernels (mesh_scene) ---


def show_rays(label, bad, o, d, t_limit, k_cols, p_cols) -> None:
    """Print up to 5 rays of ``bad`` (a mask) with the kernel's and the
    plain version's answers (tuples of columns)."""
    for i in bad.nonzero()[:5, 0].tolist():
        print(f"  {label} ray {i}: origin {o[i].tolist()}, direction {d[i].tolist()}, "
              f"t_limit {float(t_limit[i])!r}, kernel {[float(c[i]) for c in k_cols]}, "
              f"plain {[float(c[i]) for c in p_cols]}")


def check_closest(label, k, p, o, d, t_limit) -> float:
    """Kernel rows ``k`` against plain rows ``p`` (``[N, 8]``: t, idx, u, v,
    normal xyz, model) on the same rays: winners, and every column of every
    ray but a NaN ray's (NaN in both), equal; prints the rays that differ.
    Returns max |k - p| over the rays with finite inputs."""
    nan_lane = ~(torch.isfinite(o).all(1) & torch.isfinite(d).all(1))
    same = k[:, 1] == p[:, 1]
    bad = ~same | (~nan_lane & ~(k == p).all(1))
    cmp = ~nan_lane
    err = (k[cmp] - p[cmp]).abs().max().item() if bool(cmp.any()) else 0.0
    print(f"closest {label}: {k.shape[0]} rays, winners equal to plain "
          f"{same.float().mean().item():.6f}, rays differing in any column {int(bad.sum())}, "
          f"max |kernel - plain| {err:.3g}, hits {(p[:, 1] >= 0).float().mean().item():.3f}")
    show_rays(f"closest {label}", bad, o, d, t_limit, (k[:, 1], k[:, 0]), (p[:, 1], p[:, 0]))
    check(not bool(bad.any()), (label, int(bad.sum())))
    check(bool((k[nan_lane, 1] == -1).all()), f"{label}: NaN lanes must report no hit")
    return err


def check_any(label, k, p, o, d, t_limit) -> float:
    """Kernel any-hit flags against plain ones on lanes with t_limit > 0;
    prints the rays that differ; returns max |k - p| over those lanes."""
    pos = t_limit > 0
    # counted, not averaged: a float mean of all-equal flags need not be 1.0
    bad = pos & (k != p)
    differ = int(bad.sum())
    err = (k[pos].float() - p[pos].float()).abs().max().item() if bool(pos.any()) else 0.0
    nan_lane = ~(torch.isfinite(o).all(1) & torch.isfinite(d).all(1))
    print(f"any {label}: {k.shape[0]} rays, flags differing from plain on the "
          f"{int(pos.sum())} t_limit > 0 lanes: {differ}, occluded "
          f"{p[pos].float().mean().item():.3f}, NaN lanes flagged {int(k[nan_lane].sum())}")
    show_rays(f"any {label}", bad, o, d, t_limit, (k,), (p,))
    check(differ == 0, (label, differ))
    check(not bool(k[nan_lane].any()), f"{label}: NaN lanes must report no hit")
    return err


def dense_need(dc, walk, eng, o, d, t_limit, t_stop, stop_chunk=None):
    """(ray x row pairs, distinct chunks, their rows) that a dense query on
    these rays needs: `needed_work` over the table's chunk boxes (``cab``),
    the rows of each chunk a ray's own slab test enters before ``t_stop``;
    with ``stop_chunk`` (a shadow query) the chunk of each ray's closest
    occluder alone."""
    cab, t = eng["cab"], eng["aux"].shape[0]
    span = torch.clamp(t - torch.arange(cab.shape[0], device=cab.device) * dc.CH, max=dc.CH)
    pairs, used, _ = needed_work(walk, cab[:, 0:3], cab[:, 3:6], span, o, d, t_limit, t_stop,
                                 stop_chunk)
    return pairs, int(used.sum()), int(span[used].sum())


def dense_bound(n, key, need):
    """Least time of one dense query on n rays from `dense_need`'s count:
    the needed pairs' float32 operations; the rays in and out, the needed
    chunks' rows (closest: the 96-byte rows, shading included; any hit: the
    48-byte planes) and boxes read once."""
    pairs, chunks, rows = need
    out_bytes, row_bytes = (32, 96) if key == "closest" else (1, 48)
    return bound_ms(pairs * FLOPS[key], n * (28 + out_bytes) + rows * row_bytes + chunks * 24)


def dense_ties(dc, dev) -> float:
    """The tie set (`dense_cuda.tie_soup`: one triangle in chunks 7 and 15,
    twice in chunk 7, every ray's closest hit): kernel against plain on
    every ray, the lowest index winning."""
    from path_tracer_tpu_torch.scene import triangle as tri_mod

    pos, o, d = dc.tie_soup()
    eng = {"aux": torch.from_numpy(dc.pack_dense_aux(tri_mod.precompute(pos))).to(dev),
           "cab": torch.from_numpy(dc.pack_dense_cab(pos)).to(dev)}
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    tl = torch.full((o.shape[0],), 3.0e38, device=dev)
    p = dc.closest_plain(eng["aux"], o, d, tl)
    check(bool((p[:, 1] == dc.TIE_ROWS[0]).all()), "dense tie set: the lowest index wins")
    return check_closest("tie set", dc.closest_cuda(eng, o, d, tl), p, o, d, tl)


def time_dense_against(label, other, key, eng, this, rays, reps, card):
    """Time another tree's dense kernel (``other``, `start_other_builds`)
    against this tree's (``this()``) on the same rays, in turns (other,
    this, this, other); their outputs must be equal (closest: on the rays
    with finite inputs)."""
    qo, qd, qt = rays
    n, dev = qo.shape[0], qo.device
    out = (torch.empty((n, 8), dtype=torch.float32, device=dev) if key == "closest"
           else torch.empty(n, dtype=torch.bool, device=dev))
    fn = other.dense_closest if key == "closest" else other.dense_any
    aux, cab = eng["aux"], eng["cab"]

    def run_other():
        err = fn(dev.index, aux.data_ptr(), cab.data_ptr(), aux.shape[0], qo.data_ptr(),
                 qd.data_ptr(), qt.data_ptr(), n, out.data_ptr(), None,
                 torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"{label}: cudaError {err}")
        return out

    finite = torch.isfinite(qo).all(1) & torch.isfinite(qd).all(1)
    same = ((lambda a, b: torch.equal(a[finite], b[finite])) if key == "closest" else torch.equal)
    turns(f"{label} {key}, {n} rays", run_other, this, reps, card, same)


def phase_dense(dc, walk, scene, cam, dev, card, others=()):
    """Phase 3: kernel vs plain vs float64 oracle on a mixed ray set, the
    cull's edge cases and the tie set; then kernel vs plain again, and both
    timed, at the render's shapes, with the cull's counters and the tested
    against the needed pairs; each of ``others`` (other trees' libraries)
    has its dense kernels timed beside this one's at every shape."""
    eng, leng = scene["tri"]["dense"], scene["light"]["dense"]
    aux = eng["aux"]
    rng = np.random.default_rng(1234)
    print(f"dense table: {aux.shape[0]} rows, {eng['cab'].shape[0]} chunks of {dc.CH}; lights: "
          f"{leng['aux'].shape[0]} rows, {leng['cab'].shape[0]} chunk")

    # 65,536 camera rays + 65,536 random rays inside the Cornell box
    o_cam, d_cam = camera_rays(cam, CAMERA_GRID, CAMERA_GRID, dev)
    o_rnd = rng.uniform((-278, 0, -278), (278, 555, 278), (N_RANDOM, 3)).astype(np.float32)
    o = torch.cat([o_cam, torch.as_tensor(o_rnd, device=dev)])
    d = torch.cat([d_cam, unit_rows(rng, N_RANDOM, dev)])
    n = o.shape[0]
    tl = torch.full((n,), math.inf, device=dev)
    lanes = edge_lanes(rng, o, d, tl, dev)
    tlc = torch.clamp(tl, max=3.0e38)

    k = dc.closest_cuda(eng, o, d, tlc)
    p = dc.closest_plain(aux, o, d, tlc)
    errs = {"closest": check_closest("mixed", k, p, o, d, tlc)}
    oracle = dc.closest_plain(aux.double(), o.double(), d.double(), tlc.double())
    oracle_agree = (k[:, 1].double() == oracle[:, 1]).float().mean().item()
    print(f"closest mixed: winners equal to the float64 oracle {oracle_agree:.6f}")
    check(oracle_agree >= ORACLE_AGREE, oracle_agree)

    # any-hit: shadow-like limits around each ray's closest t, plus the edge lanes
    t_hit = torch.where(p[:, 1] >= 0, p[:, 0], 1000.0)
    scale = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
    tl_any = torch.where(torch.isinf(tl), t_hit * scale, tl)
    tl_any[torch.as_tensor(lanes[1152:1664], device=dev)] = math.inf
    tl_anyc = torch.clamp(tl_any, max=3.0e38)
    ka = dc.any_cuda(eng, o, d, tl_anyc)
    pa = dc.any_plain(aux, o, d, tl_anyc)
    errs["any"] = check_any("mixed", ka, pa, o, d, tl_any)

    # the cull's edge cases (axis-parallel rays, rays from and along chunk
    # box faces, limits one ulp either side of a closest t) and the tie set
    lo, hi = eng["cab"][:, 0:3], eng["cab"][:, 3:6]
    finite = torch.isfinite(o).all(1) & torch.isfinite(d).all(1)
    ks = torch.where(finite & (tlc > 0), k[:, 1], -1.0).long()
    eo, ed, et = edge_rays(rng, lo, hi, lo.amin(0), hi.amax(0), o, d, k[:, 0], ks, dev)
    errs["any"] = max(errs["any"], check_any(
        "edge cases", dc.any_cuda(eng, eo, ed, et), dc.any_plain(aux, eo, ed, et), eo, ed, et))
    errs["closest"] = max(errs["closest"], check_closest(
        "edge cases", dc.closest_cuda(eng, eo, ed, et), dc.closest_plain(aux, eo, ed, et), eo, ed,
        et))
    errs["closest"] = max(errs["closest"], dense_ties(dc, dev))

    # The render's shapes: the world query over the whole film's camera
    # rays, then over as many bounce rays (random directions from the
    # camera hits), the lights pretest over as many rays from the surface
    # (half toward the light, half in random directions), and one any-hit
    # over 2N shadow rays toward the light. Kernel and plain are compared on
    # every ray of each.
    o_f, d_f = camera_rays(cam, WIDTH, HEIGHT, dev)
    nf = o_f.shape[0]
    tl_f = torch.full((nf,), 3.0e38, device=dev)
    hit_f = dc.closest_cuda(eng, o_f, d_f, tl_f)
    hit_m = hit_f[:, 1] >= 0
    p_hit = (o_f + d_f * torch.where(hit_m, hit_f[:, 0], 0.0)[:, None]).contiguous()
    d_b = unit_rows(rng, nf, dev)
    tl_b = torch.where(hit_m, 3.0e38, 0.0)
    o_s = torch.cat([p_hit, p_hit])
    vec = light_targets(rng, scene, 2 * nf, dev) - o_s
    dist = vec.norm(dim=1)
    d_s = (vec / dist[:, None]).contiguous()
    tl_s = torch.where(torch.cat([hit_m, hit_m]), dist * (1 - 5e-4), 0.0)
    d_l = torch.where((torch.arange(nf, device=dev) % 2 == 0)[:, None], d_s[:nf],
                      unit_rows(rng, nf, dev)).contiguous()
    # each shadow ray's closest occluder, for the shadow query's need
    occ = dc.closest_cuda(eng, o_s, d_s, tl_s)[:, 1].long()
    occ_chunk = torch.where(occ >= 0, occ // dc.CH, -1)
    # name: (key, table, rays, reps)
    queries = {
        "camera": ("closest", eng, (o_f, d_f, tl_f), 5),
        "bounce": ("closest", eng, (p_hit, d_b, tl_b), 5),
        "lights": ("closest", leng, (p_hit, d_l, tl_f), 5),
        "shadow": ("any", eng, (o_s, d_s, tl_s), 5),
    }
    results = {}
    for name, (key, tab, (qo, qd, qt), reps) in queries.items():
        kern = dc.closest_cuda if key == "closest" else dc.any_cuda
        plain = dc.closest_plain if key == "closest" else dc.any_plain
        km, kout = time_ms(lambda: kern(tab, qo, qd, qt), reps)
        pm, pout = time_ms(lambda: plain(tab["aux"], qo, qd, qt), 1)
        if key == "any":
            err = check_any(f"render shape {name}", kout, pout, qo, qd, qt)
            need = dense_need(dc, walk, tab, qo, qd, qt, qt, occ_chunk)
        else:
            err = check_closest(f"render shape {name}", kout, pout, qo, qd, qt)
            need = dense_need(dc, walk, tab, qo, qd, qt, torch.where(kout[:, 1] >= 0, kout[:, 0], qt))
        errs[key] = max(errs[key], err)
        stats = dc.dense_stats(tab, qo, qd, qt, query=key)
        nq, nt = qo.shape[0], tab["aux"].shape[0]
        bms, by = dense_bound(nq, key, need)
        results[name] = {"ms": km, "plain_ms": pm, "bound_ms": bms, "bound_by": by, "rays": nq,
                         "stats": stats, "needed_pairs": need[0], "tested_pairs": stats["pairs"]}
        lanes_, blocks = max(stats["lanes"], 1), max(stats["blocks"], 1)
        print(f"dense {name}: pairs tested {stats['pairs']}, needed {need[0]}: tested / needed "
              f"{stats['pairs'] / max(need[0], 1):.3f} (every row: {stats['lanes'] * nt}); chunks "
              f"entered per lane {stats['entered'] / lanes_:.2f}, staged per block "
              f"{stats['staged'] / blocks:.2f}; entering lanes per staged chunk "
              f"{stats['listed'] / max(stats['staged'], 1):.2f}")
        print(f"time {name}: kernel {km:.3f} ms, plain {pm:.3f} ms, bound {bms:.4f} ms ({by}) "
              f"from {need[0]} needed pairs in {need[1]} chunks, at {nq} rays x {nt} table rows "
              f"({card})")
        for other in (o for o in others if o.dense_closest is not None):
            time_dense_against(f"dense {name} vs {other.label}", other, key, tab,
                               lambda: kern(tab, qo, qd, qt), (qo, qd, qt), reps, card)
    return errs, results


@contextlib.contextmanager
def prebuilt_dragon(scenes, sh, cam):
    """Within the block, ``scenes.dragon_scene`` returns the host scene
    ``(sh, cam)`` that phase 6 built (the CLI's baked 1024x576 call) instead
    of building it again, and raises for any other arguments; restored on
    leaving the block."""
    build = scenes.dragon_scene

    def reuse(**kw):
        if kw != {"aspect": WIDTH / HEIGHT, "two_level": False}:
            raise ValueError(f"prebuilt_dragon: no host scene for {kw}")
        return sh, cam

    scenes.dragon_scene = reuse
    try:
        yield
    finally:
        scenes.dragon_scene = build


def zero_launches():
    from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    return LAUNCHES


def check_film(film, width, height, spp) -> float:
    """A rendered film's checks; returns its mean radiance per sample."""
    check(film.shape == (height, width, 4), tuple(film.shape))
    check(bool(torch.isfinite(film).all()), "film has non-finite values")
    mean = film[..., :3].mean().item() / spp
    check(mean > 0.0, mean)
    check(bool((film[..., 3] == spp).all()), "sample count in the film's alpha")
    return mean


def render_cli(scene_name, spp, card, keys, width=WIDTH, height=HEIGHT, two_level=False,
               absent=(), ext=".png"):
    """One offline render through the CLI to ``smoke_<scene><ext>``, launch
    counts zeroed just before and read just after; checks the film, that
    ``keys`` launched and that ``absent`` did not."""
    from path_tracer_tpu_torch import cli

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    tag = "_two_level" if two_level else ""
    LAUNCHES = zero_launches()
    t0 = time.perf_counter()
    res = cli.main([
        "--scene", scene_name, "--width", str(width), "--height", str(height),
        "--spp", str(spp), "--max-bounces", str(MAX_BOUNCES),
        "--out", str(OUT_DIR / f"smoke_{Path(scene_name).stem}{tag}{ext}"), "--device", DEVICE,
        *(["--two-level"] if two_level else []),
    ])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    mean = check_film(res["film"], width, height, spp)
    ph = res["phases"]
    print(f"render {scene_name}{' --two-level' if two_level else ''} {width}x{height} {spp} spp "
          f"(engine {res['engine']}): {seconds:.2f} s end to end, "
          f"host build {ph['scene build'] + ph['upload']:.2f} s (scene {ph['scene build']:.2f} s, "
          f"upload {ph['upload']:.2f} s), trace {res['trace_s']:.2f} s, "
          f"{res['mrays_per_s']:.4f} Mrays/s, {res['spp_per_s']:.4f} spp/s, "
          f"mean radiance {mean:.5f}, launches {launches} ({card})")
    check(all(launches[k] > 0 for k in keys), (keys, launches))
    check(all(launches[k] == 0 for k in absent), (absent, launches))
    return launches, res


def cross_backend(make, width, height, spp, engine=None, max_bounces=MAX_BOUNCES):
    """The same render on the CPU (plain versions) and on the card; returns
    the card's image mean."""
    from path_tracer_tpu_torch.integrator.wavefront import render

    means = {}
    for dev in ("cpu", DEVICE):
        sh, cam = make()
        t0 = time.perf_counter()
        film = render(sh, cam, width, height, spp, dev, max_bounces=max_bounces, engine=engine)
        means[dev] = film[..., :3].mean().item()
        print(f"  {width}x{height} {spp} spp, {max_bounces} bounces on {dev}"
              f"{f' ({engine})' if engine else ''}: "
              f"mean {means[dev]:.6f} ({time.perf_counter() - t0:.1f} s)")
    rel = abs(means[DEVICE] - means["cpu"]) / means["cpu"]
    print(f"  cross-backend mean rel diff {rel:.5f} (limit {MEAN_TOL})")
    check(rel <= MEAN_TOL, rel)
    return means[DEVICE]


# --- the scene inputs and the host runtime (phase 26) ---

ASSET_SCENE = "assets/asset_scene.json"  # paths inside are relative to the repo root
JPEG_SCENE = "assets/asset_scene_jpeg.json"  # asset_scene.json under assets/sky.jpg
JPEG_DIGESTS = "assets/jpeg_digests.json"  # SHA-256 of Pillow's decode of each committed JPEG
JPEG_PSNR_MIN = 30.0  # dB: a decoded JPEG (quality 75 or 90) against the bytes it encoded
JPEG_DECODE_LIMIT_S = 5.0  # the 2048x4096 sky's decode on the card's host


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """Peak signal-to-noise ratio of two uint8 images, in dB."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * math.log10(255.0 ** 2 / mse)


def phase_jpeg(sky, card):
    """Phase 26's image codecs (``utils/imageio.py``, no Pillow here): the
    committed JPEGs decoded through the native library to Pillow's digests;
    the JPEG-sky asset scene through the CLI to a ``.jpg`` (rows 1-2
    launched), the file decoded against the film's tonemapped bytes; the
    scene CPU against card; the 2048x4096 sky ``sky`` encoded at quality 90
    and decoded, timed."""
    import hashlib

    from path_tracer_tpu_torch import native
    from path_tracer_tpu_torch.film import film_to_srgb
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.utils import config, imageio

    check(native.available(), "the native library is not available (g++)")
    for path, want in json.loads(Path(JPEG_DIGESTS).read_text()).items():
        t0 = time.perf_counter()
        rgb = imageio.decode_image(Path(path).read_bytes(), path)
        seconds = time.perf_counter() - t0
        same = list(rgb.shape) == want["shape"] and hashlib.sha256(rgb.tobytes()).hexdigest() == want["sha256"]
        print(f"  {path}: {rgb.shape[1]}x{rgb.shape[0]} decoded in {seconds * 1e3:.1f} ms (native), "
              f"{'equal to' if same else 'NOT equal to'} Pillow's digest")
        check(same, path)
    wavefront.STEPS.update(bounce=0, calls=0, reads=0)
    launches, res = render_cli(JPEG_SCENE, SPP, card, ("closest", "any"), ext=".jpg")
    print(f"  {JPEG_SCENE}: {wavefront.STEPS['bounce']} bounce steps, trace {res['trace_s']:.2f} s, "
          f"scene build {res['phases']['scene build']:.3f} s (sky.jpg through the port's JPEG "
          f"decoder), launches of PERF.md §6 rows 1-2: closest {launches['closest']}, "
          f"any {launches['any']} ({card})")
    data = Path(res["out"]).read_bytes()
    check(data[:3] == b"\xff\xd8\xff", f"{res['out']} is not a JPEG file")
    film8 = np.clip(film_to_srgb(res["film"]).cpu().numpy() * 255.0, 0, 255).astype(np.uint8)[::-1]
    db = psnr(imageio.decode_image(data, res["out"]), film8)
    print(f"  {Path(res['out']).name}: {len(data)} bytes, its decode against the film's tonemapped "
          f"bytes (the PNG's) PSNR {db:.2f} dB (limit {JPEG_PSNR_MIN})")
    check(db >= JPEG_PSNR_MIN, db)
    print(f"{JPEG_SCENE}:")
    cross_backend(lambda: (config.load_scene_json(JPEG_SCENE),
                           config.load_camera_json(JPEG_SCENE, 1.0)), 32, 32, 2)
    rgb8 = np.clip(np.power(np.maximum(sky, 0.0), 1 / 2.2) * 255.0, 0, 255).astype(np.uint8)
    t0 = time.perf_counter()
    data = imageio.encode_jpeg(rgb8, 90)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = imageio.decode_jpeg(data, "procedural_sky.jpg")
    t_dec = time.perf_counter() - t0
    db = psnr(back, rgb8)
    print(f"  procedural_sky(h=2048) {rgb8.shape[1]}x{rgb8.shape[0]} at quality 90: {len(data)} bytes, "
          f"encode {t_enc:.3f} s, decode {t_dec:.3f} s (limit {JPEG_DECODE_LIMIT_S} s), "
          f"PSNR {db:.2f} dB (native entropy coder and DCTs, the card's host; {card})")
    check(t_dec < JPEG_DECODE_LIMIT_S and db >= JPEG_PSNR_MIN, (t_dec, db))
    return launches


TIFF_SCENE = "assets/asset_scene_tiff.json"  # asset_scene.json under assets/sky.tif (sky.png's pixels)
FORMAT_DIGESTS = "assets/format_digests.json"  # SHA-256 of Pillow's decode of each committed format file
FORMAT_SPP = 2  # the TIFF-sky and PNG-sky renders of phase_formats
FORMAT_OUTS = (".tif", ".bmp", ".dib", ".ppm", ".tga", ".gif", ".apng")
GIF_PSNR_MIN = 30.0  # dB, the film's GIF against its tonemapped bytes (a CPU render of the scene at 128x72, 2 spp: 40.76)
WEBP_SCENE = "assets/asset_scene_webp.json"  # asset_scene.json under assets/sky.webp (lossless, sky.png's pixels)
WEBP_DIGESTS = "assets/webp_digests.json"  # SHA-256 of Pillow's decode of each committed WebP file
# dB, the film's .webp against its tonemapped bytes (a CPU render of the scene at 64x36, 2 spp, 8 bounces: 35.21)
WEBP_PSNR_MIN = 30.0


def phase_formats(sky, card):
    """Phase 26's other raster formats (``utils/{tiff,gif,bmp,netpbm,
    tga}.py``, no Pillow here): (a) the committed files decoded through the
    native library to Pillow's digests; (b) the TIFF-sky asset scene and
    the PNG-sky one through the CLI at 1024x576, 2 spp (rows 1-2
    launched), their films equal pixel for pixel; (c) the TIFF-sky film
    through ``film.save_png`` to each new extension and decoded back:
    lossless ones equal to the tonemapped bytes, the GIF's PSNR held to
    ``GIF_PSNR_MIN``; (d) the 2048x4096 sky ``sky`` through the GIF, TIFF,
    BMP and WebP writers and readers, timed, the decodes under
    ``JPEG_DECODE_LIMIT_S``. WebP (``utils/{webp,vp8,vp8l}.py``): the
    committed WebP files against ``WEBP_DIGESTS`` in (a), the WebP-sky
    scene beside the other two in (b), the film's ``.webp`` held to
    ``WEBP_PSNR_MIN`` in (c)."""
    import hashlib

    from path_tracer_tpu_torch import native
    from path_tracer_tpu_torch.film import film_to_srgb, save_png
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.utils import imageio

    t_phase = time.perf_counter()
    check(native.available(), "the native library is not available (g++)")
    digests = {**json.loads(Path(FORMAT_DIGESTS).read_text()), **json.loads(Path(WEBP_DIGESTS).read_text())}
    for path, want in digests.items():
        data = Path(path).read_bytes()
        t0 = time.perf_counter()
        rgb = imageio.decode_image(data, path)
        seconds = time.perf_counter() - t0
        same = list(rgb.shape) == want["shape"] and hashlib.sha256(rgb.tobytes()).hexdigest() == want["sha256"]
        print(f"  {path}: {len(data)} bytes, {rgb.shape[1]}x{rgb.shape[0]} decoded in {seconds * 1e3:.1f} ms "
              f"(native), {'equal to' if same else 'NOT equal to'} Pillow's digest")
        check(same, path)
    films, launches = {}, {}
    for scene in (TIFF_SCENE, WEBP_SCENE, ASSET_SCENE):
        wavefront.STEPS.update(bounce=0, calls=0, reads=0)
        launches[scene], res = render_cli(scene, FORMAT_SPP, card, ("closest", "any"))
        films[scene] = res["film"]
        print(f"  {scene}: {wavefront.STEPS['bounce']} bounce steps, trace {res['trace_s']:.2f} s, "
              f"scene build {res['phases']['scene build']:.3f} s, launches of PERF.md §6 rows 1-2: "
              f"closest {launches[scene]['closest']}, any {launches[scene]['any']} ({card})")
    for scene, label in ((TIFF_SCENE, "TIFF"), (WEBP_SCENE, "WebP")):
        differ = int((films[scene] != films[ASSET_SCENE]).any(dim=-1).sum())
        print(f"  {label}-sky against PNG-sky film: {differ} of {WIDTH * HEIGHT} pixels differ (limit 0)")
        check(differ == 0, (label, differ))
    film8 = np.clip(film_to_srgb(films[TIFF_SCENE]).cpu().numpy() * 255.0, 0, 255).astype(np.uint8)[::-1]
    for ext in (*FORMAT_OUTS, ".webp"):
        out = OUT_DIR / f"smoke_film{ext}"
        t0 = time.perf_counter()
        save_png(out, films[WEBP_SCENE if ext == ".webp" else TIFF_SCENE])
        t_write = time.perf_counter() - t0
        data = out.read_bytes()
        t0 = time.perf_counter()
        back = imageio.decode_image(data, str(out))
        t_read = time.perf_counter() - t0
        if ext in (".gif", ".webp"):
            db, limit = psnr(back, film8), GIF_PSNR_MIN if ext == ".gif" else WEBP_PSNR_MIN
            print(f"  {out.name}: {len(data)} bytes, write {t_write:.3f} s, read {t_read:.3f} s, "
                  f"PSNR against the film's tonemapped bytes {db:.2f} dB (limit {limit})")
            check(db >= limit, (ext, db))
        else:
            same = back.shape == film8.shape and bool((back == film8).all())
            print(f"  {out.name}: {len(data)} bytes, write {t_write:.3f} s, read {t_read:.3f} s, "
                  f"{'equal to' if same else 'NOT equal to'} the film's tonemapped bytes")
            check(same, out.name)
    rgb8 = np.clip(np.power(np.maximum(sky, 0.0), 1 / 2.2) * 255.0, 0, 255).astype(np.uint8)
    for fmt in ("gif", "tiff", "bmp", "webp"):
        t0 = time.perf_counter()
        data = imageio._ENCODERS[fmt](rgb8)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = imageio.decode_image(data, f"procedural_sky.{fmt}")
        t_dec = time.perf_counter() - t0
        quality = (f"PSNR {psnr(back, rgb8):.2f} dB" if fmt in ("gif", "webp")
                   else f"{'equal' if bool((back == rgb8).all()) else 'NOT equal'} to the pixels")
        print(f"  procedural_sky(h=2048) {rgb8.shape[1]}x{rgb8.shape[0]} as {fmt.upper()}: {len(data)} bytes, "
              f"write {t_enc:.3f} s, read {t_dec:.3f} s (limit {JPEG_DECODE_LIMIT_S} s), {quality} "
              f"(native loops, the card's host; {card})")
        check(t_dec < JPEG_DECODE_LIMIT_S, (fmt, t_dec))
        check(fmt in ("gif", "webp") or bool((back == rgb8).all()), fmt)
    print(f"  phase 26 (formats): {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches[TIFF_SCENE]


def host_build_s(models, env, use_native: bool) -> float:
    """Seconds of one baked host scene build (``Scene(...)``: the world and
    light SAH builds, the triangle tables) with the native builder or the
    NumPy one."""
    from path_tracer_tpu_torch import native
    from path_tracer_tpu_torch.scene.scene import Scene

    with patched(native, **({} if use_native else {"available": lambda: False})):
        t0 = time.perf_counter()
        Scene(models, env=env)
        return time.perf_counter() - t0


def phase_inputs(dc, walk, dev, card):
    """Phase 26: JSON scenes with OBJ models and PNG, JPEG and TIFF skies,
    env_sphere_scene, the dense kernels against their plain versions on the
    asset scene's world table, the native builder and the disk cache on the
    card's machine, the image codecs (`phase_jpeg`, `phase_formats`) and
    the CLI's ``--profile-dir``."""
    import tempfile

    from path_tracer_tpu_torch import cli, native, scenes
    from path_tracer_tpu_torch.scene import procedural
    from path_tracer_tpu_torch.utils import config, disk_cache, profiling

    check(native.available(), "the native builder is not available (g++)")
    launches = {}
    with contextlib.chdir(ROOT):
        launches["asset"], res = render_cli(ASSET_SCENE, SPP, card, ("closest", "any"))
        print(f"  asset scene: {res['phases']['scene build']:.2f} s scene build (JSON, OBJ "
              "through the native parser, sky.png through the port's PNG decoder, native SAH)")
        # phase 3's comparison on this table: above 64 chunks, so the high
        # words of the kernels' chunk mask run
        asset = config.load_scene_json(ASSET_SCENE)
        asset_dev = asset.device(DEVICE)
        check(asset_dev["tri"]["dense"]["cab"].shape[0] > 64, "the asset table has <= 64 chunks")
        print("asset_scene.json world table (phase 3's checks):")
        asset_cam = config.load_camera_json(ASSET_SCENE, WIDTH / HEIGHT)
        _, asset_t = phase_dense(dc, walk, asset_dev, asset_cam, dev, card)
        print("  asset scene kernel ms: " + ", ".join(
            f"{k} {r['ms']:.3f} (plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.4f})"
            for k, r in asset_t.items()) + f" ({card})")
        del asset_dev
        # no lights: no shadow rays, so no any-hit launch
        launches["env_sphere"], _ = render_cli("env_sphere_scene", SPP, card, ("closest",),
                                               absent=("any",))
        print("asset_scene.json:")
        cross_backend(lambda: (config.load_scene_json(ASSET_SCENE),
                               config.load_camera_json(ASSET_SCENE, 1.0)), 32, 32, 2)
        print("env_sphere_scene:")
        cross_backend(scenes.env_sphere_scene, 32, 32, 2)

        # host builds: native against NumPy on the asset scene; the dragon
        # native only (its NumPy build, 75.7-82.2 s on the H100's host, is
        # in PERF.md §5)
        t_asset = {w: host_build_s(asset.models, asset.env, w) for w in (True, False)}
        sh, _ = scenes.dragon_scene(aspect=WIDTH / HEIGHT)
        t_dragon = host_build_s(sh.models, sh.env, True)
        print(f"  host build, native / NumPy: asset scene ({asset.num_world_tris} tris) "
              f"{t_asset[True]:.2f} / {t_asset[False]:.2f} s; native: dragon_scene "
              f"({sh.num_world_tris} tris) {t_dragon:.2f} s (its NumPy build: 58-100 s in the "
              "smoke before the native builder, PERF.md §5)")
        del sh

        # the disk cache: a miss (generate and write) against a hit (read)
        old, made = os.environ.get("PT_HOST_CACHE"), {}
        with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
            os.environ["PT_HOST_CACHE"] = tmp
            try:
                for label, fn, kw in (("knot", procedural.knot, {"scale": 42.0, "nu": 768, "nv": 288}),
                                      ("sky", scenes.procedural_sky, {"h": 2048})):
                    t = []
                    for _ in range(2):
                        t0 = time.perf_counter()
                        made[label] = disk_cache.cached_arrays(fn, **kw)
                        t.append(time.perf_counter() - t0)
                    print(f"  disk cache, dragon {label}: miss {t[0]:.2f} s, hit {t[1]:.3f} s")
            finally:
                if old is None:
                    os.environ.pop("PT_HOST_CACHE")
                else:
                    os.environ["PT_HOST_CACHE"] = old
        launches["asset_jpeg"] = phase_jpeg(made["sky"], card)
        launches["asset_tiff"] = phase_formats(made["sky"], card)

        # --profile-dir: a trace of a small render
        prof = OUT_DIR / "prof26"
        cli.main(["--scene", "env_sphere_scene", "--width", "64", "--height", "64", "--spp", "1",
                  "--max-bounces", "8", "--device", DEVICE, "--out", str(OUT_DIR / "prof26.png"),
                  "--profile-dir", str(prof)])
        events = json.loads((prof / profiling.TRACE_FILE).read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        ours = sum("closest" in e.get("name", "") for e in kernels)
        print(f"  --profile-dir: {len(events)} trace events, {len(kernels)} kernels on the card "
              f"({ours} dense closest-hit)")
    for k, v in launches.items():
        print(f"  phase 26 launches, {k}: closest {v['closest']}, any {v['any']}")
    return launches


# --- the walk kernels (dragon_scene) ---


def check_walk_closest(label, kt, ks, pt, ps, nan_lane, kind="walk") -> float:
    """Kernel (best_t, slot) against plain on the same rays (sorted for the
    walk): winners and t equal on every ray (the walk's cull is exact and
    its arithmetic the plain version's); returns max |t_kernel - t_plain|
    over the lanes whose winners agree."""
    same = ks == ps
    agree = same.float().mean().item()
    err = (kt[same] - pt[same]).abs().max().item() if bool(same.any()) else 0.0
    print(f"{kind} closest {label}: {ks.shape[0]} rays, winners equal to plain {agree:.6f}, "
          f"max |t kernel - t plain| {err:.3g}, hits {(ps >= 0).float().mean().item():.3f}")
    check(bool(same.all()) and torch.equal(kt, pt), (label, agree, err))
    check(bool((ks[nan_lane] == -1).all()), f"{label}: NaN lanes must report no hit")
    return err


def whole_blocks(rng, live, count):
    """Rows of ``count`` random whole 128-ray blocks among those with a live
    lane, in order (a block's visit order depends on its first ray, so
    subsets keep whole blocks; the ray count is a multiple of 128 here)."""
    cand = torch.unique(live.nonzero()[:, 0] // 128).cpu().numpy()
    blk = np.sort(rng.choice(cand, size=min(count, cand.size), replace=False))
    return torch.as_tensor((blk[:, None] * 128 + np.arange(128)).reshape(-1), device=live.device)


def chunk_spans(walk, eng):
    """Real triangles per chunk in layout order (pad rows of ``aux`` are
    zero rows), int64 [chunks]."""
    k = walk.num_chunks(eng)
    return (eng["aux"][:, :12] != 0).any(1).view(k, walk.CH_W).sum(1)


def needed_work(walk, lo, hi, span, o, d, t_limit, t_stop, stop_col=None, col_inst=None):
    """What a query on these rays needs, from each ray's own slab test
    against every gate box (columns of ``lo``/``hi`` [E, 3], ``span`` [E]
    real triangles each): a live ray needs the real triangles of every box
    it enters at t <= ``t_stop``. With ``stop_col`` (a shadow query), a ray
    whose entry is >= 0 (the column of its closest occluder) needs only that
    box's triangles. Returns (ray x triangle pairs, the used-column mask,
    the (ray, instance) transforms: the distinct ``col_inst`` [E] of each
    ray's entered boxes, 0 without ``col_inst``)."""
    e, dev = span.numel(), o.device
    live = walk._valid(o, d, t_limit)
    used = torch.zeros(e, dtype=torch.bool, device=dev)
    pairs = xforms = 0
    if stop_col is not None:
        occ = live & (stop_col >= 0)
        pairs += int(span[stop_col[occ].long()].sum())
        used[stop_col[occ].long()] = True
        xforms += int(occ.sum()) if col_inst is not None else 0
        live = live & ~occ
    onehot = None
    if col_inst is not None:
        onehot = torch.zeros(e, int(col_inst.max()) + 1, device=dev)
        onehot[torch.arange(e, device=dev), col_inst.long()] = 1.0
    rows = live.nonzero()[:, 0]
    step = max(1, (1 << 25) // e)
    for s in range(0, rows.numel(), step):
        r = rows[s : s + step]
        oo, dd, ts = o[r, None, :], d[r, None, :], t_stop[r, None]
        d0 = dd == 0.0
        inv = 1.0 / torch.where(d0, 1.0, dd)
        t1, t2 = (lo - oo) * inv, (hi - oo) * inv
        inside = (oo >= lo) & (oo <= hi)
        near = torch.where(d0, torch.where(inside, -1e30, 1e30), torch.minimum(t1, t2)).amax(2)
        far = torch.where(d0, torch.where(inside, 1e30, -1e30), torch.maximum(t1, t2)).amin(2)
        enter = (near <= far) & (far >= 0.0) & (near <= ts)
        pairs += int(torch.where(enter, span, 0).sum())
        used |= enter.any(0)
        if onehot is not None:
            xforms += int(((enter.float() @ onehot) > 0).sum())
    return pairs, used, xforms


def needed_walk_work(walk, eng, o, d, t_limit, t_stop, stop_chunk=None):
    """(ray x triangle pairs, distinct chunks, their real triangles) that a
    walk query on these rays needs (`needed_work` over the chunk boxes;
    ``stop_chunk`` the layout chunk of each shadow ray's closest occluder)."""
    spans = chunk_spans(walk, eng)
    k = spans.numel()
    cols = eng["ord_oct"][0, :k].long()  # octant 0's box columns, in layout chunks
    col_of = torch.empty_like(cols)
    col_of[cols] = torch.arange(k, device=cols.device)
    stop_col = None
    if stop_chunk is not None:
        stop_col = torch.where(stop_chunk >= 0, col_of[stop_chunk.clamp(min=0).long()], -1)
    pairs, used, _ = needed_work(
        walk, eng["cb_oct"][0, 0:3, :k].T.contiguous(), eng["cb_oct"][0, 3:6, :k].T.contiguous(),
        spans[cols], o, d, t_limit, t_stop, stop_col)
    return pairs, int(used.sum()), int(spans[cols][used].sum())


def walk_bound(n, out_bytes, need, key):
    """Least time of one walk query on n rays from ``needed_walk_work``'s
    count: the needed pairs' float32 operations; the rays in and out, and
    the needed chunks' plane rows (48 B per real triangle) and boxes (24 B)
    read once."""
    pairs, chunks, tris = need
    return bound_ms(pairs * FLOPS[key], n * (28 + out_bytes) + tris * 48 + chunks * 24)


EDGE_RAYS = 512  # axis-parallel rays, and as many from chunk box faces
EDGE_ULP = 2048  # hit rays whose limit is set one ulp either side of their t


def edge_rays(rng, lo, hi, root_lo, root_hi, o, d, kt, ks, dev, to_world=None):
    """The segment cull's edge cases, for the any-hit kernels: axis-parallel
    rays from random points of the scene box; rays from random points of
    random gate boxes' faces (``lo``/``hi`` [E, 3]), half of them moving
    within the face's plane (with ``to_world``, object-space boxes: those
    rays then go through ``to_world(box index, origin, direction)``); and
    ``EDGE_ULP`` of the rays ``o, d`` that hit (closest t ``kt``, ``ks`` >=
    0), each twice, with its limit one ulp above and one ulp below its t.
    Returns (origin, direction, t_limit)."""
    n = EDGE_RAYS
    ar = torch.arange(n, device=dev)
    u = lambda *shape: torch.as_tensor(rng.uniform(size=shape).astype(np.float32), device=dev)  # noqa: E731
    o_ax = root_lo + (root_hi - root_lo) * u(n, 3)
    d_ax = torch.zeros((n, 3), device=dev)
    d_ax[ar, ar % 3] = 1.0 - 2.0 * (ar % 2).float()
    c = torch.as_tensor(rng.integers(0, lo.shape[0], n), device=dev)
    a = torch.as_tensor(rng.integers(0, 3, n), device=dev)
    o_f = lo[c] + (hi[c] - lo[c]) * u(n, 3)
    o_f[ar, a] = torch.where(ar % 2 == 0, lo[c, a], hi[c, a])
    d_f = unit_rows(rng, n, dev)
    d_f[ar % 4 < 2, a[ar % 4 < 2]] = 0.0
    d_f = d_f / d_f.norm(dim=1, keepdim=True)
    if to_world is not None:
        o_f, d_f = to_world(c, o_f, d_f)
    hit = (ks >= 0).nonzero()[:, 0].cpu().numpy()
    hit = torch.as_tensor(np.sort(rng.choice(hit, min(EDGE_ULP, hit.size), replace=False)), device=dev)
    t = kt[hit]
    big = torch.full((n,), 3.0e38, device=dev)
    return (torch.cat([o_ax, o_f, o[hit], o[hit]]).contiguous(),
            torch.cat([d_ax, d_f, d[hit], d[hit]]).contiguous(),
            torch.cat([big, big, torch.nextafter(t, torch.full_like(t, math.inf)),
                       torch.nextafter(t, torch.zeros_like(t))]).contiguous())


def walk_ties(walk, dev) -> float:
    """The tie set (`walk.tie_soup`): every ray's closest hit is one triangle
    held in two chunks of the walk tables, twice within one; kernel against
    plain, winners and t equal on every ray, each chunk winning some
    octants."""
    pos, o, d = walk.tie_soup()
    tables, slots = walk.tie_tables(pos, pos.shape[0] - 1)
    eng = {k: torch.from_numpy(v).to(dev) for k, v in tables.items()}
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    tl = torch.full((o.shape[0],), math.inf, device=dev)
    kt, ks = walk.closest_cuda(eng, o, d, tl)
    pt, ps = walk.closest_plain(eng, o, d, tl)
    check(set(ps.tolist()) == set(slots[:2]), ("tie set winners", slots, torch.unique(ps)))
    return check_walk_closest("tie set", kt, ks, pt, ps, torch.zeros_like(ks, dtype=torch.bool))


def two_level_ties(iwalk, walk, dev) -> tuple:
    """The tie sets of the two-level kernels, every ray's closest hit one
    triangle T of `walk.tie_soup`: vwalk on two coincident instances of the
    soup with T held twice; iwalk on two coincident instances with T also
    held twice in a second object chunk (`iwalk.tie_tables`). Kernel
    against plain, winners, instances and t equal on every ray; iwalk's any
    hit against plain with limits just past and just short of T. Returns
    (vwalk closest, iwalk closest, iwalk any) max errors."""
    from path_tracer_tpu_torch.scene.model import Model, rigid_transform, rotation_y

    pos, o, d = walk.tie_soup()
    m = rigid_transform(rotation_y(0.7), (0.5, 0.2, -0.1))
    veng = iwalk.upload(iwalk.pack_vwalk(
        [Model(None, matrices=[m, m], positions=np.concatenate([pos, pos[-1:]]))]), dev)
    tables, slots = iwalk.tie_tables(pos, pos.shape[0] - 1, m)
    ieng = iwalk.upload(tables, dev)
    rot, tr = torch.from_numpy(m[:, :3]).to(dev), torch.from_numpy(m[:, 3]).to(dev)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    ow, dw = (o @ rot.T + tr).contiguous(), (d @ rot.T).contiguous()
    tl = torch.full((o.shape[0],), math.inf, device=dev)
    none = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
    k, p = iwalk.closest_cuda(veng, ow, dw, tl), iwalk.closest_plain(veng, ow, dw, tl)
    check(bool((p[1] >= 0).all()), "vwalk tie set: every ray hits")
    errs = [check_two_level_closest("vwalk closest tie set", k, p, none)]
    k, p = iwalk.closest_cuda(ieng, ow, dw, tl), iwalk.closest_plain(ieng, ow, dw, tl)
    first = ieng["ord_oct"][walk._block_octant(dw), 0]
    check(bool((p[1] == min(slots)).all()) and torch.equal(p[2], first),
          ("iwalk tie set: the first instance, lowest chunk and lane win", slots))
    errs.append(check_two_level_closest("iwalk closest tie set", k, p, none))
    any_err = 0.0
    for scale, want in ((1.001, True), (0.999, False)):
        lim = (p[0] * scale).contiguous()
        ka, pa = iwalk.any_cuda(ieng, ow, dw, lim), iwalk.any_plain(ieng, ow, dw, lim)
        check(bool((pa == want).all()), f"iwalk tie set: limits x{scale}")
        any_err = max(any_err, check_any(f"iwalk tie set, limits x{scale}", ka, pa, ow, dw, lim))
    return (*errs, any_err)


def iwalk_to_world(iwalk, eng, rng):
    """``to_world`` of `edge_rays` for iwalk's object chunk boxes: each ray
    through the forward rigid transform (`iwalk.to_world`) of a random
    instance whose chunk range holds its box."""

    def to_world(c, o, d):
        holds = (c[:, None] >= eng["inst_c"][None, :, 0]) & (c[:, None] < eng["inst_c"][None, :, 1])
        pick = torch.as_tensor(rng.uniform(size=tuple(holds.shape)), device=c.device) * holds
        return iwalk.to_world(eng, pick.argmax(dim=1), o, d)

    return to_world


def kernel_sources(csrc: Path, name: str) -> list:
    """(file, text) of ``csrc/<name>.cu`` and of every header it includes
    (quoted includes, followed), sorted."""
    seen, todo = {}, [f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f not in seen:
            seen[f] = (csrc / f).read_text()
            todo += re.findall(r'#include "([^"]+)"', seen[f])
    return sorted(seen.items())


def start_other_builds(srcs):
    """Start nvcc on ``dense_hit.cu``, ``walk_hit.cu``, ``iwalk_hit.cu``,
    ``dense_stream.cu`` and ``gather_probe.cu`` of each csrc directory in
    ``srcs`` (a parent commit's, or a variant of it) with this tree's flags,
    beside phase 2's builds, skipping a source whose text and headers equal
    this tree's (nothing to compare); returns a function that waits for
    them, prints their ptxas lines and returns, per directory, its label
    and its entry points (ctypes; None where skipped):
    ``dense_closest``/``dense_any``, ``walk_closest``/``walk_any``,
    ``vwalk_closest``/``vwalk_any``, ``iwalk_closest``/``iwalk_any`` and
    ``stream_closest``/``stream_any``, each with this tree's signature, and
    ``probe``, the probe kernels' wrappers (`gather.other_probe`)."""
    import ctypes
    import shutil

    from path_tracer_tpu_torch.probes import gather
    from path_tracer_tpu_torch.trace import cuda_lib

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    jobs = []
    for idx, src in enumerate(srcs):
        out = OUT_DIR / "parent" / str(idx)
        out.mkdir(parents=True, exist_ok=True)
        for name in ("dense_hit", "walk_hit", "iwalk_hit", "dense_stream", "gather_probe"):
            if kernel_sources(src, name) == kernel_sources(cuda_lib.CSRC, name):
                print(f"{src}: {name}.cu and its headers equal this tree's; not timed")
                continue
            proc = subprocess.Popen(
                [nvcc, *cuda_lib.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"), str(src / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((idx, src, name, out / f"lib{name}.so", proc))

    def finish():
        libs = {}
        for idx, src, name, lib, proc in jobs:
            log, _ = proc.communicate()
            check(proc.returncode == 0, f"{src} {name}: nvcc failed:\n{log}")
            for line in log.splitlines():
                if ptxas_line(line):
                    print(f"  ptxas {src} {name}:", line.strip())
            libs[idx, name] = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        others = []
        for idx, src in enumerate(srcs):
            fns, other = {}, SimpleNamespace(label=str(src), dense_closest=None, dense_any=None,
                                             walk_closest=None, walk_any=None,
                                             vwalk_closest=None, vwalk_any=None,
                                             iwalk_closest=None, iwalk_any=None,
                                             stream_closest=None, stream_any=None, probe=None)
            if (idx, "dense_hit") in libs:
                sig = [i, p, p, i, p, p, p, i, p, p, p]
                fns["dense_closest"] = (libs[idx, "dense_hit"].dense_closest, sig)
                fns["dense_any"] = (libs[idx, "dense_hit"].dense_any, sig)
            if (idx, "walk_hit") in libs:
                head = [i, p, p, p, i, i, p, p, p, i]
                fns["walk_closest"] = (libs[idx, "walk_hit"].walk_closest, head + [p, p, p, p])
                fns["walk_any"] = (libs[idx, "walk_hit"].walk_any, head + [p, p, p])
            if (idx, "iwalk_hit") in libs:
                head = [i, p, p, p, p, p, p, i, i, ctypes.c_float, p, p, p, i]
                fns["vwalk_closest"] = (libs[idx, "iwalk_hit"].vwalk_closest, head + [p, p, p, p, p])
                fns["vwalk_any"] = (libs[idx, "iwalk_hit"].vwalk_any, head + [p, p, p])
                head = [i, p, p, p, p, p, p, p, p, i, i, ctypes.c_float, p, p, p, i]
                fns["iwalk_closest"] = (libs[idx, "iwalk_hit"].iwalk_closest, head + [p, p, p, p, p])
                fns["iwalk_any"] = (libs[idx, "iwalk_hit"].iwalk_any, head + [p, p, p])
            if (idx, "dense_stream") in libs:
                head = [i, p, p, p, p, i, i, p, p, p, i]
                fns["stream_closest"] = (libs[idx, "dense_stream"].stream_closest, head + [p, p, p, p])
                fns["stream_any"] = (libs[idx, "dense_stream"].stream_any, head + [p, p, p])
            for key, (fn, types) in fns.items():
                fn.argtypes, fn.restype = types, ctypes.c_int
                setattr(other, key, fn)
            if (idx, "gather_probe") in libs:
                other.probe = gather.other_probe(libs[idx, "gather_probe"], src)
            others.append(other)
        return others

    return finish


def ptxas_line(line: str) -> bool:
    """The lines of nvcc's ptxas output worth printing: each kernel's name,
    registers and spills."""
    return "Compiling entry function" in line or "registers" in line or "spill" in line


def time_against(label, fn, tables, this, rays, n_out, reps, card):
    """Time another tree's kernel ``fn`` (its C entry point; ``tables`` its
    arguments before the rays) against this tree's (``this()``) on the same
    rays, in turns: other, this, this, other, ``reps`` launches each. Their
    outputs must be equal: a closest hit's ``n_out`` (t, slot, and for the
    two-level ones the instance), or with ``n_out`` 0 an any hit's flags."""
    qo, qd, qt = rays
    n, dev = qo.shape[0], qo.device
    if n_out:
        outs = [torch.empty(n, dtype=torch.float32, device=dev)]
        outs += [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(n_out - 1)]
    else:
        outs = [torch.empty(n, dtype=torch.bool, device=dev)]

    def run_other():
        err = fn(dev.index, *tables, qo.data_ptr(), qd.data_ptr(), qt.data_ptr(), n,
                 *[x.data_ptr() for x in outs], None, torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"{label}: cudaError {err}")
        return outs if n_out else outs[0]

    same = (lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))) if n_out else torch.equal
    turns(f"{label}, {n} rays {'closest' if n_out else 'any'}", run_other, this, reps, card, same)


def turns(label, run_other, this, reps, card, same) -> None:
    """Time ``run_other()`` and ``this()`` in turns (other, this, this,
    other; ``reps`` launches each), check ``same(this(), run_other())`` and
    print the four times and the ratio."""
    times = [time_ms(run_other if who == "other" else this, reps)[0]
             for who in ("other", "this", "this", "other")]
    check(same(this(), run_other()), f"{label}: outputs differ")
    print(f"A/B {label}, {reps} launches each: other {times[0]:.3f} ms, this "
          f"{times[1]:.3f} ms, this {times[2]:.3f} ms, other {times[3]:.3f} ms; other / this "
          f"{(times[0] + times[3]) / (times[1] + times[2]):.2f}x ({card})")


def phase_walk(walk, scene, cam, dev, card, others=()):
    """Phases 6-7: the walk kernels against their plain versions on the full
    dragon world table, on a mixed ray set, the cull's edge cases, the tie
    set and at the render's shapes; each of ``others`` (other trees'
    libraries, `start_other_builds`) has its closest hit timed beside this
    one's."""
    eng = scene["tri"]["walk"]
    rng = np.random.default_rng(4321)
    k = walk.num_chunks(eng)
    print(f"walk table: {k} chunks, {eng['aux'].shape[0]} slots, "
          f"{eng['aux'].numel() * 4 / 2**20:.1f} MiB aux")

    # 6: 32,768 camera rays + 32,768 random rays inside the Cornell box
    o_cam, d_cam = camera_rays(cam, 256, 128, dev)
    o_rnd = rng.uniform((-278, 0, -278), (278, 555, 278), (32768, 3)).astype(np.float32)
    o = torch.cat([o_cam, torch.as_tensor(o_rnd, device=dev)])
    d = torch.cat([d_cam, unit_rows(rng, 32768, dev)])
    n = o.shape[0]
    tl = torch.full((n,), math.inf, device=dev)
    lanes = edge_lanes(rng, o, d, tl, dev)
    order, o_s, d_s, tl_s = walk._sorted_rays(eng, o, d, tl)
    nan_s = ~(torch.isfinite(o_s).all(1) & torch.isfinite(d_s).all(1))
    kt, ks = walk.closest_cuda(eng, o_s, d_s, tl_s)
    pt, ps = walk.closest_plain(eng, o_s, d_s, tl_s)
    errs = {"walk_closest": check_walk_closest("mixed", kt, ks, pt, ps, nan_s)}
    rows = whole_blocks(rng, walk._valid(o_s, d_s, tl_s), 32)  # 4,096 rays
    eng64 = {**eng, "aux": eng["aux"].double()}
    _, os64 = walk.closest_plain(eng64, o_s[rows].double(), d_s[rows].double(), tl_s[rows].double())
    oracle_agree = (ks[rows] == os64).float().mean().item()
    print(f"walk closest mixed: winners equal to the float64 plain version {oracle_agree:.6f} "
          f"on {rows.numel()} rays")
    check(oracle_agree >= ORACLE_AGREE, oracle_agree)
    # any hit: limits around each ray's closest t (unsorted rays), plus the edge lanes
    hit_t = torch.empty_like(kt)
    hit_t[order] = torch.where(ks >= 0, kt, 1000.0)
    scale = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
    tl_any = torch.where(torch.isinf(tl), hit_t * scale, tl)
    tl_any[torch.as_tensor(lanes[1152:1664], device=dev)] = math.inf
    tl_anyc = walk._exit_clamp(eng, o, d, tl_any).contiguous()
    ka = walk.any_cuda(eng, o, d, tl_anyc)
    pa = walk.any_plain(eng, o, d, tl_anyc)
    errs["walk_any"] = check_any("walk mixed", ka, pa, o, d, tl_any)

    # 7: the segment cull's edge cases and the tie set, then the render's shapes
    eo, ed, et = edge_rays(rng, *walk.chunk_boxes(eng), eng["root_lo"], eng["root_hi"],
                           o_s, d_s, kt, ks, dev)
    etc = walk._exit_clamp(eng, eo, ed, et).contiguous()
    errs["walk_any"] = max(errs["walk_any"], check_any(
        "walk edge cases", walk.any_cuda(eng, eo, ed, etc), walk.any_plain(eng, eo, ed, etc),
        eo, ed, etc))
    nan_e = torch.zeros(eo.shape[0], dtype=torch.bool, device=dev)
    errs["walk_closest"] = max(errs["walk_closest"], check_walk_closest(
        "edge cases", *walk.closest_cuda(eng, eo, ed, etc), *walk.closest_plain(eng, eo, ed, etc),
        nan_e))
    errs["walk_closest"] = max(errs["walk_closest"], walk_ties(walk, dev))

    o_f, d_f = camera_rays(cam, WIDTH, HEIGHT, dev)
    nf = o_f.shape[0]
    tl_f = torch.full((nf,), math.inf, device=dev)
    order_f, o_fs, d_fs, tl_fs = walk._sorted_rays(eng, o_f, d_f, tl_f)
    ct, cs = walk.closest_cuda(eng, o_fs, d_fs, tl_fs)
    hit_s = cs >= 0
    p_hit = o_fs + d_fs * torch.where(hit_s, ct, 0.0)[:, None]  # camera hits, sorted order
    d_b = unit_rows(rng, nf, dev)
    tl_b = torch.where(hit_s, math.inf, 0.0)
    _, o_bs, d_bs, tl_bs = walk._sorted_rays(eng, p_hit, d_b, tl_b)
    hit_px = torch.empty_like(p_hit)
    hit_px[order_f] = p_hit  # back to pixel order, as the integrator holds them
    hit_pxm = torch.empty_like(hit_s)
    hit_pxm[order_f] = hit_s
    o_sh = torch.cat([hit_px, hit_px]).contiguous()
    vec = light_targets(rng, scene, 2 * nf, dev) - o_sh
    dist = vec.norm(dim=1)
    d_sh = (vec / dist[:, None]).contiguous()
    tl_sh = torch.where(torch.cat([hit_pxm, hit_pxm]), dist * (1 - 5e-4), 0.0)
    tl_shc = walk._exit_clamp(eng, o_sh, d_sh, tl_sh).contiguous()
    # each shadow ray's closest occluder, for the shadow query's needed work
    _, o_ss, d_ss, tl_ss = walk._sorted_rays(eng, o_sh, d_sh, tl_sh)
    _, occ_slot = walk.closest_cuda(eng, o_ss, d_ss, tl_ss)
    occ_chunk = torch.where(occ_slot >= 0, occ_slot // walk.CH_W, -1)
    # name: (kernel, its inputs, the public query's inputs for walk_stats, reps)
    shapes = {
        "camera": ("walk_closest", (o_fs, d_fs, tl_fs), (o_f, d_f, tl_f), 5),
        "bounce": ("walk_closest", (o_bs, d_bs, tl_bs), (p_hit, d_b, tl_b), 2),
        "shadow": ("walk_any", (o_sh, d_sh, tl_shc), (o_sh, d_sh, tl_sh), 2),
    }
    results = {}
    for name, (key, (qo, qd, qt), public, reps) in shapes.items():
        nq = qo.shape[0]
        if key == "walk_closest":
            km, (kt, ks) = time_ms(lambda: walk.closest_cuda(eng, qo, qd, qt), reps)
            rows = whole_blocks(rng, walk._valid(qo, qd, qt), PLAIN_RAYS // 128)
            pm, (pt, ps) = time_plain(lambda r: walk.closest_plain(eng, qo[r], qd[r], qt[r]), rows)
            nan_r = ~(torch.isfinite(qo[rows]).all(1) & torch.isfinite(qd[rows]).all(1))
            err = check_walk_closest(f"render shape {name}", kt[rows], ks[rows], pt, ps, nan_r)
            stats = walk.walk_stats(eng, *public)
            need = needed_walk_work(walk, eng, qo, qd, qt, torch.where(ks >= 0, kt, qt))
            out_bytes = 8
            for other in (o for o in others if o.walk_closest is not None):
                time_against(f"walk {name} vs {other.label}", other.walk_closest, walk._tables(eng),
                             lambda: walk.closest_cuda(eng, qo, qd, qt), (qo, qd, qt), 2, reps, card)
        else:
            km, ka = time_ms(lambda: walk.any_cuda(eng, qo, qd, qt), reps)
            live = walk._valid(qo, qd, qt).nonzero()[:, 0].cpu().numpy()
            rows = torch.as_tensor(np.sort(rng.choice(live, PLAIN_RAYS, replace=False)), device=dev)
            pm, pa = time_plain(lambda r: walk.any_plain(eng, qo[r], qd[r], qt[r]), rows)
            err = check_any(f"walk render shape {name}", ka[rows], pa, qo[rows], qd[rows], qt[rows])
            stats = walk.walk_stats(eng, *public, query="any")
            need = needed_walk_work(walk, eng, o_ss, d_ss, tl_ss, tl_ss, occ_chunk)
            out_bytes = 1
            for other in (o for o in others if o.walk_any is not None):
                time_against(f"walk {name} vs {other.label}", other.walk_any, walk._tables(eng),
                             lambda: walk.any_cuda(eng, qo, qd, qt), (qo, qd, qt), 0, reps, card)
        print(f"walk {name}: pairs tested {stats['pairs']}, needed {need[0]}: tested / "
              f"needed {stats['pairs'] / max(need[0], 1):.3f}; per block: gate survivors "
              f"admitted {stats['visits'] / max(stats['blocks'], 1):.1f}, chunks staged "
              f"{stats['staged'] / max(stats['blocks'], 1):.1f}; entering lanes per staged "
              f"chunk {stats['lane_visits'] / max(stats['staged'], 1):.2f}")
        errs[key] = max(errs[key], err)
        bms, by = walk_bound(nq, out_bytes, need, key)
        live = max(stats["blocks"], 1)
        tested = stats["pairs"]
        results[name] = {"key": key, "ms": km, "plain_ms": pm, "bound_ms": bms, "bound_by": by,
                         "rays": nq, "stats": stats, "needed_pairs": need[0],
                         "tested_pairs": tested}
        print(f"time walk {name}: kernel {km:.3f} ms at {nq} rays, plain {pm:.3f} ms at "
              f"{rows.numel()} rays, bound {bms:.3f} ms ({by}) from {need[0]} needed pairs "
              f"in {need[1]} chunks; pairs the kernel tested {tested}; blocks with a live lane "
              f"{stats['blocks']}, chunks visited per block {stats['visits'] / live:.1f}, "
              f"staged per block {stats['staged'] / live:.1f}, skipped by the window per block "
              f"{stats['skipped'] / live:.1f}, testing lanes per staged chunk "
              f"{stats['lane_visits'] / max(stats['staged'], 1):.1f}, distinct chunks staged "
              f"{stats['chunks']} of {k} ({card})")
    pub_ms, _ = time_ms(lambda: walk.walk_closest_hit_shade(eng, o_f, d_f, tl_f), 3)
    print(f"time walk camera public query (sort, kernel, unsort, epilogue): {pub_ms:.3f} ms")
    return errs, results


# --- the two-level kernels (two-level dragon_scene, many_instance_scene) ---


def check_two_level_closest(label, k, p, nan_lane) -> float:
    """Kernel (best_t, slot, inst) against plain on the same sorted rays:
    winners, instances and t equal on every ray (both two-level culls are
    exact and their arithmetic the plain versions'); returns max |t kernel
    - t plain| over the lanes whose winners agree."""
    same = (k[1] == p[1]) & (k[2] == p[2])
    agree = same.float().mean().item()
    err = (k[0][same].double() - p[0][same].double()).abs().max().item() if bool(same.any()) else 0.0
    print(f"{label}: {k[1].shape[0]} rays, winners (slot, instance) equal to plain {agree:.6f}, "
          f"max |t kernel - t plain| {err:.3g}, hits {(p[1] >= 0).float().mean().item():.3f}")
    check(bool(same.all()) and torch.equal(k[0], p[0]), (label, agree, err))
    check(bool((k[1][nan_lane] == -1).all()) and bool((k[2][nan_lane] == -1).all()),
          f"{label}: NaN lanes must report no hit")
    return err


def vwalk_need(walk, veng, o, d, t_limit, t_stop, stop=None):
    """`needed_work` of a vwalk query over its virtual chunks' world boxes
    (the boxes it culls); ``stop`` = (slot, inst) of each shadow ray's
    closest occluder (-1: none). Returns (pairs, transforms, boxes: the
    virtual chunks, real triangles of the distinct object chunks,
    instances) needed."""
    g = veng["gates"]
    v = veng["ord_oct"][0, :g].long()  # octant 0's box columns, in layout slots
    vg, vi = veng["vglob"][v].long(), veng["vinst"][v].long()
    spans = (veng["aux"][:, :12] != 0).any(1).view(-1, walk.CH_W).sum(1)
    stop_col = None
    if stop is not None:
        slot, inst = stop
        key = vi * spans.numel() + vg
        order = torch.argsort(key)
        q = inst.long().clamp(min=0) * spans.numel() + slot.long().clamp(min=0) // walk.CH_W
        pos = torch.searchsorted(key[order], q).clamp(max=g - 1)
        stop_col = torch.where(slot >= 0, order[pos], -1)
    lo = veng["cb_oct"][0, 0:3, :g].T.contiguous()
    hi = veng["cb_oct"][0, 3:6, :g].T.contiguous()
    pairs, used, xforms = needed_work(walk, lo, hi, spans[vg], o, d, t_limit, t_stop, stop_col, vi)
    return (pairs, xforms, int(used.sum()), int(spans[torch.unique(vg[used])].sum()),
            int(torch.unique(vi[used]).numel()))


def iwalk_need(walk, ieng, o, d, t_limit, t_stop, stop=None):
    """What an iwalk query on these rays needs, over its own cull entries,
    each (instance, object chunk) a column: a live ray needs the real
    triangles of every entry it enters within ``t_stop`` by
    `iwalk.entry_enters` (the kernel's test of the widened instance box,
    then of the part and chunk boxes on its object-space ray, the finest
    boxes it culls). With ``stop`` = (slot, inst) of each shadow ray's
    closest occluder (-1: none), an occluded ray needs only that entry's
    triangles. Returns (pairs, transforms: the distinct (ray, instance) of
    the needed entries, boxes: the distinct object chunks' and instances',
    real triangles of those object chunks, instances) needed."""
    from path_tracer_tpu_torch.trace import iwalk

    dev, ch = o.device, walk.CH_W
    segs, _, _ = iwalk._columns(ieng, dev)
    chunk = torch.cat([torch.arange(a // ch, b // ch, device=dev) for _, a, b, _ in segs])
    inst = torch.cat([torch.full(((b - a) // ch,), i, device=dev) for i, a, b, _ in segs])
    obj_spans = (ieng["aux"][:, :12] != 0).any(1).view(-1, ch).sum(1)
    spans, e, n_inst = obj_spans[chunk], chunk.numel(), ieng["inst_f"].shape[0]
    live = walk._valid(o, d, t_limit)
    used = torch.zeros(e, dtype=torch.bool, device=dev)
    pairs = xforms = 0
    if stop is not None:
        slot, sinst = stop
        first = torch.zeros(n_inst, dtype=torch.int64, device=dev)  # column of chunk 0 per instance
        first[[i for i, *_ in segs]] = torch.tensor([c // ch - a // ch for _, a, _, c in segs], device=dev)
        occ = live & (slot >= 0)
        col = first[sinst[occ].long()] + slot[occ].long() // ch
        pairs += int(spans[col].sum())
        used[col] = True
        xforms += int(occ.sum())
        live = live & ~occ
    onehot = torch.zeros(e, n_inst, device=dev)
    onehot[torch.arange(e, device=dev), inst] = 1.0
    rows = live.nonzero()[:, 0]
    step = max(1, (1 << 26) // e)  # entry_enters tests part and chunk boxes on rows in the instance
    for s in range(0, rows.numel(), step):
        r = rows[s : s + step]
        enter = iwalk.entry_enters(ieng, o[r], d[r], t_stop[r])
        pairs += int(torch.where(enter, spans, 0).sum())
        used |= enter.any(0)
        xforms += int(((enter.float() @ onehot) > 0).sum())
    chunks, insts = torch.unique(chunk[used]), int(torch.unique(inst[used]).numel())
    return pairs, xforms, chunks.numel() + insts, int(obj_spans[chunks].sum()), insts


def two_level_bound(n, out_bytes, need, key):
    """Least time of one two-level query on n rays from `vwalk_need`'s or
    `iwalk_need`'s count: the pairs' and transforms' float32 operations;
    the rays in and out, the needed object chunks' plane rows (48 B per
    real triangle), boxes (24 B) and instance transforms (48 B) read
    once."""
    pairs, xforms, boxes, tris, insts = need
    return bound_ms(pairs * FLOPS[key] + xforms * XFORM_FLOPS,
                    n * (28 + out_bytes) + tris * 48 + boxes * 24 + insts * 48)


def phase_two_level_dragon(iwalk, walk, walk_eng, sh, cam, dev, card):
    """Phase 11: the two-level dragon (made from the baked host scene's
    models) through both engines, against their plain versions, float64,
    and the baked walk."""
    from path_tracer_tpu_torch.scene.scene import Scene

    t0 = time.perf_counter()
    sh2 = Scene(sh.models, env=sh.env, two_level=True)
    t1 = time.perf_counter()
    scene2 = sh2.device(DEVICE)
    veng = scene2["twolevel"]["iwalk"]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ieng = iwalk.upload(sh2.twolevel.tables("iwalk"), dev)
    torch.cuda.synchronize()
    geo = sh2.twolevel
    mib = lambda nbytes: f"{nbytes / 2**20:.1f} MiB"  # noqa: E731
    walk_bytes = sum(v.numel() * v.element_size() for v in walk_eng.values())
    print(f"two-level dragon: {geo.num_object_tris} object tris, {geo.num_chunks} object chunks, "
          f"{geo.num_virtual_chunks} virtual chunks, {geo.num_instances} instances; host scene "
          f"with vwalk packing {t1 - t0:.2f} s, upload {t2 - t1:.2f} s, iwalk packing and "
          f"upload {time.perf_counter() - t2:.2f} s; tables on the card: vwalk "
          f"{mib(iwalk.table_bytes(veng))}, iwalk {mib(iwalk.table_bytes(ieng))}, baked walk "
          f"{mib(walk_bytes)}")
    rng = np.random.default_rng(5678)
    o_cam, d_cam = camera_rays(cam, *TWO_CAMERA, dev)
    o_rnd = rng.uniform((-278, 0, -278), (278, 555, 278), (TWO_RANDOM, 3)).astype(np.float32)
    o = torch.cat([o_cam, torch.as_tensor(o_rnd, device=dev)])
    d = torch.cat([d_cam, unit_rows(rng, TWO_RANDOM, dev)])
    n = o.shape[0]
    tl = torch.full((n,), math.inf, device=dev)
    lanes = edge_lanes(rng, o, d, tl, dev)
    order, o_s, d_s, tl_s = walk._sorted_rays(veng, o, d, tl)
    nan_s = ~(torch.isfinite(o_s).all(1) & torch.isfinite(d_s).all(1))
    k = iwalk.closest_cuda(veng, o_s, d_s, tl_s)
    p = iwalk.closest_plain(veng, o_s, d_s, tl_s)
    errs = {"vwalk_closest": check_two_level_closest("vwalk closest mixed", k, p, nan_s)}
    rows = whole_blocks(rng, walk._valid(o_s, d_s, tl_s), SUBSET // 128)
    eng64 = {**veng, "aux": veng["aux"].double(), "inst_f": veng["inst_f"].double()}
    p64 = iwalk.closest_plain(eng64, o_s[rows].double(), d_s[rows].double(), tl_s[rows].double())
    oracle_agree = ((k[1][rows] == p64[1]) & (k[2][rows] == p64[2])).float().mean().item()
    print(f"vwalk closest mixed: winners equal to the float64 plain version {oracle_agree:.6f} "
          f"on {rows.numel()} rays")
    check(oracle_agree >= ORACLE_AGREE, oracle_agree)
    sub = (o_s[rows].contiguous(), d_s[rows].contiguous(), tl_s[rows].contiguous())
    ik_ms, ik = time_ms(lambda: iwalk.closest_cuda(ieng, *sub), 1)
    ip = iwalk.closest_plain(ieng, *sub)
    errs["iwalk_closest"] = check_two_level_closest("iwalk closest mixed subset", ik, ip, nan_s[rows])
    print(f"  iwalk closest on the {rows.numel()}-ray subset: {ik_ms:.3f} ms ({card})")
    # iwalk and vwalk are one function: the same t on every ray (a tie may
    # go to another winner: their visit orders differ)
    ia = iwalk.closest_cuda(ieng, o_s, d_s, tl_s)
    same = (ia[1] == k[1]).float().mean().item()
    print(f"iwalk vs vwalk kernels on the {n} mixed rays: t equal on every ray "
          f"{torch.equal(ia[0], k[0])}, winners equal {same:.6f}")
    check(torch.equal(ia[0], k[0]) and same >= WINNER_AGREE, ("iwalk vs vwalk", same))
    # any hit: limits around each ray's closest t (unsorted rays), plus the edge lanes
    hit_t = torch.empty_like(k[0])
    hit_t[order] = torch.where(k[1] >= 0, k[0], 1000.0)
    scale = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
    tl_any = torch.where(torch.isinf(tl), hit_t * scale, tl)
    tl_any[torch.as_tensor(lanes[1152:1664], device=dev)] = math.inf
    tl_anyc = walk._exit_clamp(veng, o, d, tl_any).contiguous()
    ka = iwalk.any_cuda(veng, o, d, tl_anyc)
    pa = iwalk.any_plain(veng, o, d, tl_anyc)
    errs["vwalk_any"] = check_any("vwalk mixed", ka, pa, o, d, tl_any)
    ra = torch.as_tensor(np.sort(rng.choice(n, min(SUBSET, n), replace=False)), device=dev)
    kia = iwalk.any_cuda(ieng, o[ra], d[ra], tl_anyc[ra])
    errs["iwalk_any"] = check_any("iwalk mixed subset", kia, iwalk.any_plain(ieng, o[ra], d[ra], tl_anyc[ra]),
                                  o[ra], d[ra], tl_any[ra])
    check(torch.equal(iwalk.any_cuda(ieng, o, d, tl_anyc), ka), "iwalk vs vwalk any-hit flags")
    # the public query against the baked walk's on the same rays
    bw = walk.walk_closest_hit_shade(walk_eng, o, d, tl)
    tw = iwalk.iwalk_closest_hit_shade(veng, o, d, tl)
    hb, ht = bw[0] >= 0, tw[0] >= 0
    flags = (hb == ht).float().mean().item()
    both = hb & ht
    dt = (tw[1] - bw[1]).abs()[both]
    t_rel = (dt <= T_REL * bw[1].abs()[both]).float().mean().item()
    # float32 world coordinates carry an absolute error of about an ulp of
    # the coordinate (baked vertices round in world space, two-level ones in
    # object space), so t is held relative to the hit point's scale
    scale = torch.maximum(bw[1].abs(), (o + d * bw[1][:, None]).abs().amax(1))[both]
    t_ok = (dt <= T_REL * scale).float().mean().item()
    print(f"vwalk vs baked walk on {n} rays: hit flags equal {flags:.6f}; of {int(both.sum())} "
          f"common hits, t within rel {T_REL:g} of t on {t_rel:.6f}, of the hit point's scale "
          f"on {t_ok:.6f}")
    check(flags >= BAKED_AGREE and t_ok >= BAKED_AGREE, (flags, t_ok))
    return errs, sh2, scene2, veng, ieng


def render_shapes(iwalk, walk, eng, scene, cam, w, h, rng, dev):
    """The render's ray shapes on ``eng``: camera rays (sorted), bounce rays
    in random directions from the camera hits (sorted), 2N shadow rays
    toward the lights (pixel order, unsorted). Returns {name: (query,
    kernel inputs, public query inputs)} and each shadow ray's closest
    occluder (slot, inst) on the shadow rays sorted."""
    o_f, d_f = camera_rays(cam, w, h, dev)
    nf = o_f.shape[0]
    tl_f = torch.full((nf,), math.inf, device=dev)
    order_f, o_fs, d_fs, tl_fs = walk._sorted_rays(eng, o_f, d_f, tl_f)
    ct, cs, _ = iwalk.closest_cuda(eng, o_fs, d_fs, tl_fs)
    hit_s = cs >= 0
    p_hit = o_fs + d_fs * torch.where(hit_s, ct, 0.0)[:, None]  # camera hits, sorted order
    d_b = unit_rows(rng, nf, dev)
    tl_b = torch.where(hit_s, math.inf, 0.0)
    _, o_bs, d_bs, tl_bs = walk._sorted_rays(eng, p_hit, d_b, tl_b)
    hit_px = torch.empty_like(p_hit)
    hit_px[order_f] = p_hit  # back to pixel order, as the integrator holds them
    hit_pxm = torch.empty_like(hit_s)
    hit_pxm[order_f] = hit_s
    o_sh = torch.cat([hit_px, hit_px]).contiguous()
    vec = light_targets(rng, scene, 2 * nf, dev) - o_sh
    dist = vec.norm(dim=1)
    d_sh = (vec / dist[:, None]).contiguous()
    tl_sh = torch.where(torch.cat([hit_pxm, hit_pxm]), dist * (1 - 5e-4), 0.0)
    tl_shc = walk._exit_clamp(eng, o_sh, d_sh, tl_sh).contiguous()
    _, o_ss, d_ss, tl_ss = walk._sorted_rays(eng, o_sh, d_sh, tl_sh)
    _, occ_slot, occ_inst = iwalk.closest_cuda(eng, o_ss, d_ss, tl_ss)
    shapes = {
        "camera": ("closest", (o_fs, d_fs, tl_fs), (o_f, d_f, tl_f)),
        "bounce": ("closest", (o_bs, d_bs, tl_bs), (p_hit, d_b, tl_b)),
        "shadow": ("any", (o_sh, d_sh, tl_shc), (o_sh, d_sh, tl_sh)),
    }
    return shapes, (o_ss, d_ss, tl_ss, occ_slot, occ_inst)


def two_level_tables(eng):
    """The arguments of another tree's vwalk or iwalk entry points before
    the rays: ``eng``'s tables and sizes."""
    names = ("vinst", "vglob") if "vinst" in eng else ("inst_p", "part_c", "ocb", "opb")
    return (*[eng[t].data_ptr() for t in ("aux", "cb_oct", "ord_oct", *names, "inst_f")],
            eng["gates"], eng["ord_oct"].shape[1], float(eng["lane_slack"]))


def time_two_level(iwalk, walk, eng, shapes, occluders, label, rng, card, plain_rays=PLAIN_RAYS,
                   reps=(5, 2, 2), others=()):
    """Each shape of `render_shapes` on ``eng``'s kernel, timed with CUDA
    events, compared with the plain version on ``plain_rays`` of its rays,
    with its cull counters, its need (`vwalk_need` or `iwalk_need`, over the
    boxes the engine culls) and bound; each of ``others`` (other trees'
    libraries) has the same query timed beside this one's."""
    name = iwalk.engine_name(eng)
    need_of = vwalk_need if name == "vwalk" else iwalk_need
    results = {}
    for (shape, (query, (qo, qd, qt), public)), rep in zip(shapes.items(), reps):
        nq, key = qo.shape[0], f"{name}_{query}"
        if query == "closest":
            km, k = time_ms(lambda: iwalk.closest_cuda(eng, qo, qd, qt), rep)
            rows = whole_blocks(rng, walk._valid(qo, qd, qt), plain_rays // 128)
            pm, p = time_plain(lambda r: iwalk.closest_plain(eng, qo[r], qd[r], qt[r]), rows)
            nan_r = ~(torch.isfinite(qo[rows]).all(1) & torch.isfinite(qd[rows]).all(1))
            err = check_two_level_closest(f"{label} {shape}", [x[rows] for x in k], p, nan_r)
            need = need_of(walk, eng, qo, qd, qt, torch.where(k[1] >= 0, k[0], qt))
            out_bytes = 12
            this = lambda: iwalk.closest_cuda(eng, qo, qd, qt)  # noqa: E731
        else:
            km, ka = time_ms(lambda: iwalk.any_cuda(eng, qo, qd, qt), rep)
            live = walk._valid(qo, qd, qt).nonzero()[:, 0].cpu().numpy()
            rows = torch.as_tensor(np.sort(rng.choice(live, min(plain_rays, live.size), replace=False)),
                                   device=qo.device)
            pm, pa = time_plain(lambda r: iwalk.any_plain(eng, qo[r], qd[r], qt[r]), rows)
            err = check_any(f"{label} {shape}", ka[rows], pa, qo[rows], qd[rows], qt[rows])
            o_ss, d_ss, tl_ss, occ_slot, occ_inst = occluders
            need = need_of(walk, eng, o_ss, d_ss, tl_ss, tl_ss, (occ_slot, occ_inst))
            out_bytes = 1
            this = lambda: iwalk.any_cuda(eng, qo, qd, qt)  # noqa: E731
        for other in (o for o in others if getattr(o, key) is not None):
            time_against(f"{label} {shape} vs {other.label}", getattr(other, key),
                         two_level_tables(eng), this, (qo, qd, qt),
                         3 if query == "closest" else 0, rep, card)
        stats = iwalk.iwalk_stats(eng, *public, query=query)
        bms, by = two_level_bound(nq, out_bytes, need, key)
        blocks = max(stats["blocks"], 1)
        tested = stats["pairs"]
        results[shape] = {"key": key, "ms": km, "plain_ms": pm, "bound_ms": bms, "bound_by": by,
                          "rays": nq, "plain_rays": rows.numel(), "err": err, "stats": stats,
                          "needed_pairs": need[0], "tested_pairs": tested, "need": need}
        levels = ""
        if name == "iwalk":
            lanes = max(stats["lanes"], 1)
            levels = (f"; per valid lane: instances entered {stats['instances'] / lanes:.2f}, "
                      f"parts {stats['parts'] / lanes:.2f}, chunks {stats['chunks'] / lanes:.2f} "
                      f"({stats['lanes']} valid lanes)")
        print(f"{label} {shape}: pairs tested {tested}, needed {need[0]}: tested / needed "
              f"{tested / max(need[0], 1):.3f}; lanes listed per staged chunk "
              f"{stats['lane_visits'] / max(stats['staged'], 1):.2f}{levels}")
        print(f"time {label} {shape}: kernel {km:.3f} ms at {nq} rays, plain {pm:.3f} ms at "
              f"{rows.numel()} rays, bound {bms:.4f} ms ({by}) from {need[0]} needed pairs and "
              f"{need[1]} transforms, {need[2]} boxes ({need[3]} object tris, {need[4]} "
              f"instances); pairs the kernel tested {tested}; blocks with a "
              f"live lane {stats['blocks']}, gate entries admitted per block "
              f"{stats['visits'] / blocks:.1f}, chunks staged per block {stats['staged'] / blocks:.1f}, "
              f"skipped by the window per block {stats['skipped'] / blocks:.1f}, distinct entries "
              f"{stats['entries']} of {eng['gates']} ({card})")
    return results


def phase_two_level_shapes(iwalk, walk, scenes, scene2, veng, ieng, cam, dev, card, others=()):
    """Phase 12: vwalk and iwalk at the two-level dragon's render shapes
    (the same rays; each query beside each of ``others``'), both on the
    cull's edge cases and the tie sets, then iwalk at
    many_instance_scene's 1920x1080 (beside each of ``others``)."""
    rng = np.random.default_rng(8765)
    shapes, occ = render_shapes(iwalk, walk, veng, scene2, cam, WIDTH, HEIGHT, rng, dev)
    res = {"dragon": time_two_level(iwalk, walk, veng, shapes, occ, "vwalk dragon", rng, card,
                                    others=others),
           "dragon_iwalk": time_two_level(iwalk, walk, ieng, shapes, occ, "iwalk dragon", rng, card,
                                          others=others)}
    # both culls' edge cases, the ulp limits on camera rays
    _, (qo, qd, qt), _ = shapes["camera"]
    cam_rows = torch.arange(0, qo.shape[0], qo.shape[0] // (4 * EDGE_ULP), device=dev)
    cq = tuple(x[cam_rows].contiguous() for x in (qo, qd, qt))
    kt, ks, _ = iwalk.closest_cuda(veng, *cq)
    for name, eng, boxes, to_world in (
            ("vwalk", veng, iwalk.virtual_boxes(veng), None),
            ("iwalk", ieng, (ieng["ocb"][:, 0:3], ieng["ocb"][:, 3:6]), iwalk_to_world(iwalk, ieng, rng))):
        eo, ed, et = edge_rays(rng, *boxes, eng["root_lo"], eng["root_hi"], cq[0], cq[1], kt, ks, dev,
                               to_world)
        etc = walk._exit_clamp(eng, eo, ed, et).contiguous()
        r = res["dragon" if name == "vwalk" else "dragon_iwalk"]
        r["shadow"]["err"] = max(r["shadow"]["err"], check_any(
            f"{name} edge cases", iwalk.any_cuda(eng, eo, ed, etc), iwalk.any_plain(eng, eo, ed, etc),
            eo, ed, etc))
        nan_e = torch.zeros(eo.shape[0], dtype=torch.bool, device=dev)
        r["bounce"]["err"] = max(r["bounce"]["err"], check_two_level_closest(
            f"{name} closest edge cases", iwalk.closest_cuda(eng, eo, ed, etc),
            iwalk.closest_plain(eng, eo, ed, etc), nan_e))
    v_tie, i_tie, ia_tie = two_level_ties(iwalk, walk, dev)
    res["dragon"]["bounce"]["err"] = max(res["dragon"]["bounce"]["err"], v_tie)
    res["dragon_iwalk"]["bounce"]["err"] = max(res["dragon_iwalk"]["bounce"]["err"], i_tie)
    res["dragon_iwalk"]["shadow"]["err"] = max(res["dragon_iwalk"]["shadow"]["err"], ia_tie)
    t0 = time.perf_counter()
    sh_m, cam_m = scenes.many_instance_scene(aspect=MANY_W / MANY_H, two_level=True)
    scene_m = sh_m.device(DEVICE, engine="iwalk")
    ieng_m = scene_m["twolevel"]["iwalk"]
    print(f"many_instance_scene two-level: {sh_m.twolevel.num_instances} instances, "
          f"{sh_m.twolevel.num_chunks} object chunks, {sh_m.twolevel.num_virtual_chunks} virtual "
          f"chunks, default engine {sh_m.twolevel.engine}, host build and iwalk packing "
          f"{time.perf_counter() - t0:.2f} s")
    shapes_m, occ_m = render_shapes(iwalk, walk, ieng_m, scene_m, cam_m, MANY_W, MANY_H, rng, dev)
    res["many"] = time_two_level(iwalk, walk, ieng_m, shapes_m, occ_m, "iwalk many_instance", rng,
                                 card, others=others)
    return res, sh_m, cam_m


def render_iwalk_cli(card):
    """Phase 14, second half: ``PT_VWALK=0`` many_instance_scene
    --two-level through the CLI at 1920x1080, 1 spp: the iwalk kernels
    launch and vwalk's do not."""
    os.environ["PT_VWALK"] = "0"
    try:
        launches, res = render_cli(
            "many_instance_scene", 1, card, ("iwalk_closest", "iwalk_any", "closest"),
            width=MANY_W, height=MANY_H, two_level=True,
            absent=("vwalk_closest", "vwalk_any", "walk_closest", "walk_any"))
    finally:
        del os.environ["PT_VWALK"]
    check(res["engine"] == "iwalk", res["engine"])
    print(f"many_instance_scene --two-level PT_VWALK=0 bounce steps: {launches['iwalk_any']}")
    return launches


def render_iwalk_dragon(sh2, scene2, cam, card):
    """Phase 14, last part: ``PT_VWALK=0`` dragon_scene --two-level through
    the CLI at 1024x576, 1 spp (iwalk launches > 0, vwalk 0), then the same
    sample through vwalk in process (``scene2``, the two-level dragon's
    vwalk tables; the same seeds): image means within 1%."""
    from path_tracer_tpu_torch.integrator.wavefront import render_sample

    os.environ["PT_VWALK"] = "0"
    try:
        launches, res = render_cli(
            "dragon_scene", 1, card, ("iwalk_closest", "iwalk_any", "closest"), two_level=True,
            absent=("vwalk_closest", "vwalk_any", "walk_closest", "walk_any"))
    finally:
        del os.environ["PT_VWALK"]
    check(res["engine"] == "iwalk", res["engine"])
    print(f"dragon_scene --two-level PT_VWALK=0 bounce steps: {launches['iwalk_any']}")
    ndc = torch.as_tensor(cam.view_proj_inverse(), device=DEVICE)
    org = torch.as_tensor(cam.origin, device=DEVICE)
    t0 = time.perf_counter()
    rad, _, _, rays = render_sample(
        scene2, ndc, org, 0, WIDTH, HEIGHT, max_bounces=MAX_BOUNCES,
        has_lights="light" in scene2, spp=1, mtypes=sh2.active_mtypes, any_volumes=sh2.has_volumes)
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    vwalk_mean = rad.mean().item()
    iwalk_mean = res["film"][..., :3].mean().item()
    rel = abs(iwalk_mean - vwalk_mean) / vwalk_mean
    print(f"dragon_scene --two-level 1 spp through vwalk in process: trace {trace_s:.2f} s, "
          f"{float(rays[:, 0].sum()) / trace_s / 1e6:.4f} Mrays/s; image mean {vwalk_mean:.6f}, "
          f"iwalk {iwalk_mean:.6f}: rel diff {rel:.5f} (limit {MEAN_TOL}); trace iwalk / vwalk "
          f"{res['trace_s'] / trace_s:.2f} ({card})")
    check(rel <= MEAN_TOL, rel)
    return launches


# --- the streamed dense kernels (dragon_scene, PT_WALK=0) and the probes ---


def phase_stream(ds, dc, walk, eng, walk_eng, cam, dev, card):
    """Phase 16: the stream kernels against their plain versions on the full
    dragon table, float64, and the stream's public query against the
    walk's."""
    rng = np.random.default_rng(2468)
    print(f"stream table: {ds.num_parts(eng)} parts, {eng['cab'].shape[0]} chunks, "
          f"{eng['aux'].shape[0]} rows, {ds.table_bytes(eng) / 2**20:.1f} MiB")
    o_cam, d_cam = camera_rays(cam, *STREAM_CAMERA, dev)
    o_rnd = rng.uniform((-278, 0, -278), (278, 555, 278), (STREAM_RANDOM, 3)).astype(np.float32)
    o = torch.cat([o_cam, torch.as_tensor(o_rnd, device=dev)])
    d = torch.cat([d_cam, unit_rows(rng, STREAM_RANDOM, dev)])
    n = o.shape[0]
    tl = torch.full((n,), math.inf, device=dev)
    lanes = edge_lanes(rng, o, d, tl, dev)
    qo, qd, qt = dc._rays(o, d, tl)
    nan_lane = ~(torch.isfinite(o).all(1) & torch.isfinite(d).all(1))
    km, (kt, ki) = time_ms(lambda: ds.closest_cuda(eng, qo, qd, qt), 1)
    pt, pi = ds.closest_plain(eng, qo, qd, qt)
    errs = {"stream_closest": check_walk_closest("mixed", kt, ki, pt, pi, nan_lane, kind="stream")}
    print(f"  stream closest on the {n} mixed rays: {km:.3f} ms ({card})")
    rows = whole_blocks(rng, ds._valid(qo, qd, qt), SUBSET // 128)
    _, i64 = ds.closest_plain({"aux": eng["aux"].double()}, qo[rows].double(), qd[rows].double(),
                              qt[rows].double())
    oracle_agree = (ki[rows] == i64).float().mean().item()
    print(f"stream closest mixed: winners equal to the float64 plain version {oracle_agree:.6f} "
          f"on {rows.numel()} rays")
    check(oracle_agree >= ORACLE_AGREE, oracle_agree)
    # any hit: limits around each ray's closest t, plus the edge lanes
    scale = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
    tl_any = torch.where(torch.isinf(tl), torch.where(ki >= 0, kt, 1000.0) * scale, tl)
    tl_any[torch.as_tensor(lanes[1152:1664], device=dev)] = math.inf
    tl_anyc = torch.clamp(tl_any, max=3.0e38)
    ka = ds.any_cuda(eng, qo, qd, tl_anyc)
    errs["stream_any"] = check_any("stream mixed", ka, ds.any_plain(eng, qo, qd, tl_anyc), o, d, tl_any)
    # the cull's edge cases (axis-parallel rays, rays from and along part,
    # chunk and group box faces, limits one ulp either side of a closest t)
    # and the tie set, both queries
    boxes = torch.cat([b[(b[:, 0:3] <= b[:, 3:6]).all(1)] for b in (eng["pab"], eng["cab"], eng["qab"])])
    eo, ed, et = edge_rays(rng, boxes[:, 0:3], boxes[:, 3:6], eng["pab"][:, 0:3].amin(0),
                           eng["pab"][:, 3:6].amax(0), qo, qd, kt, ki.long(), dev)
    errs["stream_any"] = max(errs["stream_any"], check_any(
        "stream edge cases", ds.any_cuda(eng, eo, ed, et), ds.any_plain(eng, eo, ed, et), eo, ed, et))
    no_nan = torch.zeros(eo.shape[0], dtype=torch.bool, device=dev)
    errs["stream_closest"] = max(errs["stream_closest"], check_walk_closest(
        "edge cases", *ds.closest_cuda(eng, eo, ed, et), *ds.closest_plain(eng, eo, ed, et), no_nan,
        kind="stream"))
    tie_errs = stream_ties(ds, dev)
    for key in tie_errs:
        errs[key] = max(errs[key], tie_errs[key])
    # the public query against the walk's on the same rays
    sq = ds.dense_stream_closest_hit_shade(eng, o, d, tl)
    wq = walk.walk_closest_hit_shade(walk_eng, o, d, tl)
    hs, hw = sq[0] >= 0, wq[0] >= 0
    flags = (hs == hw).float().mean().item()
    other = hs & hw & (sq[0] != wq[0])
    # a different winner must sit at the same t (two triangles meeting
    # where the ray passes), to float32 rounding of the hit point
    pscale = torch.maximum(wq[1].abs(), (o + d * wq[1][:, None]).abs().amax(1))
    same_t = ((sq[1] - wq[1]).abs() <= T_REL * pscale)[other]
    print(f"stream vs walk public query on {n} rays: hit flags equal {flags:.6f}, winners equal on "
          f"{int((hs & hw & ~other).sum())} of {int((hs & hw).sum())} common hits; the "
          f"{int(other.sum())} others at the same t (rel {T_REL:g} of the hit point's scale): "
          f"{int(same_t.sum())}")
    check(flags == 1.0 and bool(same_t.all()), (flags, int(other.sum()), int(same_t.sum())))
    return errs


def stream_ties(ds, dev) -> dict:
    """The tie set (`dense_stream.tie_soup`: one triangle in parts 0 and 1,
    twice within one group of part 0, every ray's closest hit): the closest
    hit against plain on every ray, the lowest index winning; the any hit
    with limits just past each t against plain."""
    from path_tracer_tpu_torch.scene import triangle as tri_mod

    pos, o, d = ds.tie_soup()
    eng = ds.upload(ds.pack_dense_stream(tri_mod.precompute(pos), None, None, pos), dev)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    tl = torch.full((o.shape[0],), 3.0e38, device=dev)
    kt, ki = ds.closest_cuda(eng, o, d, tl)
    pt, pi = ds.closest_plain(eng, o, d, tl)
    check(bool((pi == ds.TIE_ROWS[0]).all()), "stream tie set: the lowest index wins")
    no_nan = torch.zeros_like(ki, dtype=torch.bool)
    errs = {"stream_closest": check_walk_closest("tie set", kt, ki, pt, pi, no_nan, kind="stream")}
    lim = (kt * 1.001).contiguous()
    errs["stream_any"] = check_any("stream tie set", ds.any_cuda(eng, o, d, lim),
                                   ds.any_plain(eng, o, d, lim), o, d, lim)
    return errs


def stream_need(ds, walk, eng, width, o, d, t_limit, t_stop, occ=None):
    """(ray x row pairs, boxes used, their real rows) that a stream query
    needs over the table's boxes of ``width`` rows (``ds.CH``: the chunk
    boxes ``cab``; ``ds.QH``: the group boxes ``qab``): `needed_work`, the
    real rows of each box a ray's own slab test enters before ``t_stop``;
    with ``occ`` (a shadow query: each ray's closest occluder, a soup
    index) the box of the occluder alone."""
    boxes = eng["cab"] if width == ds.CH else eng["qab"]
    spans = (eng["aux"][:, :12] != 0).any(1).view(-1, width).sum(1)
    stop = None if occ is None else torch.where(occ >= 0, occ // width, -1)
    pairs, used, _ = needed_work(walk, boxes[:, 0:3].contiguous(), boxes[:, 3:6].contiguous(), spans,
                                 o, d, t_limit, t_stop, stop)
    return pairs, int(used.sum()), int(spans[used].sum())


def stream_block_groups(ds, eng, o, d, t_limit, tw):
    """Per 128-ray block with a valid lane, the distinct groups some valid
    lane's three box tests enter within its window ``tw`` (the cull's plain
    model, `dense_stream.entered_groups`): a floor on the groups the block
    stages, whose windows close in index order, not front to back. The ray
    count is a multiple of 128."""
    valid = ds._valid(o, d, t_limit)
    counts = []
    for s in range(0, o.shape[0], 32 * ds.SBLK):
        sl = slice(s, s + 32 * ds.SBLK)
        ent = ds.entered_groups(eng, o[sl], d[sl], tw[sl]) & valid[sl, None]
        counts.append(ent.view(-1, ds.SBLK, ent.shape[1]).any(1).sum(1))
    return torch.cat(counts)[valid.view(-1, ds.SBLK).any(1)]


def time_stream_against(label, other, key, eng, this, rays, reps, card):
    """Time another tree's stream kernel (``other``, `start_other_builds`)
    against this tree's (``this()``) on the same rays, in turns (other,
    this, this, other), through the other tree's own entry point; their
    outputs (closest: t and index; any: flags) must be equal."""
    qo, qd, qt = rays
    n, dev = qo.shape[0], qo.device
    if key == "stream_closest":
        fn = other.stream_closest
        outs = [torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev)]
    else:
        fn = other.stream_any
        outs = [torch.empty(n, dtype=torch.bool, device=dev)]
    tables = [eng["aux"], eng["cab"], eng["pab"], eng["qab"]]
    sizes = [eng["pab"].shape[0], eng["cab"].shape[0] // eng["pab"].shape[0]]

    def run_other():
        err = fn(dev.index, *[x.data_ptr() for x in tables], *sizes, qo.data_ptr(), qd.data_ptr(),
                 qt.data_ptr(), n, *[x.data_ptr() for x in outs], None,
                 torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"{label}: cudaError {err}")
        return outs if key == "stream_closest" else outs[0]

    same = ((lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))) if key == "stream_closest"
            else torch.equal)
    turns(f"{label} {key}, {n} rays", run_other, this, reps, card, same)


def phase_stream_shapes(ds, dc, walk, eng, walk_eng, scene, cam, dev, card, others=()):
    """Phase 17: the stream kernels at the render's shapes in pixel order,
    against their plain versions, with their cull's counters, the tested
    against the needed pairs (over 512-row chunks and 128-row groups), the
    bound, beside the walk's public query on the same rays; each of
    ``others`` (other trees' libraries) has its stream kernels timed beside
    this one's at every shape."""
    rng = np.random.default_rng(1357)
    o_f, d_f = camera_rays(cam, WIDTH, HEIGHT, dev)
    nf = o_f.shape[0]
    tl_f = torch.full((nf,), math.inf, device=dev)
    ct, ci = ds.closest_cuda(eng, *dc._rays(o_f, d_f, tl_f))
    hit = ci >= 0
    p_hit = (o_f + d_f * torch.where(hit, ct, 0.0)[:, None]).contiguous()
    d_b = unit_rows(rng, nf, dev)
    tl_b = torch.where(hit, math.inf, 0.0)
    o_sh = torch.cat([p_hit, p_hit]).contiguous()
    vec = light_targets(rng, scene, 2 * nf, dev) - o_sh
    dist = vec.norm(dim=1)
    d_sh = (vec / dist[:, None]).contiguous()
    tl_sh = torch.where(torch.cat([hit, hit]), dist * (1 - 5e-4), 0.0)
    # each shadow ray's closest occluder (a soup index is a stream row)
    occ = walk.walk_closest_hit_shade(walk_eng, o_sh, d_sh, tl_sh)[0]
    shapes = {
        "camera": ("stream_closest", (o_f, d_f, tl_f), 3),
        "bounce": ("stream_closest", (p_hit, d_b, tl_b), 1),
        "shadow": ("stream_any", (o_sh, d_sh, tl_sh), 1),
    }
    results = {}
    for name, (key, rays, reps) in shapes.items():
        qo, qd, qt = dc._rays(*rays)
        nq = qo.shape[0]
        rows = whole_blocks(rng, ds._valid(qo, qd, qt), PLAIN_RAYS // 128)
        nan_r = ~(torch.isfinite(qo[rows]).all(1) & torch.isfinite(qd[rows]).all(1))
        if key == "stream_closest":
            km, (kt, ki) = time_ms(lambda: ds.closest_cuda(eng, qo, qd, qt), reps)
            pm, (pt, pi) = time_plain(lambda r: ds.closest_plain(eng, qo[r], qd[r], qt[r]), rows)
            err = check_walk_closest(f"render shape {name}", kt[rows], ki[rows], pt, pi, nan_r,
                                     kind="stream")
            pub_ms, _ = time_ms(lambda: ds.dense_stream_closest_hit_shade(eng, *rays), reps)
            walk_ms, _ = time_ms(lambda: walk.walk_closest_hit_shade(walk_eng, *rays), reps)
            need, need_q = (stream_need(ds, walk, eng, w, qo, qd, qt, torch.where(ki >= 0, kt, qt))
                            for w in (ds.CH, ds.QH))
            out_bytes, query = 8, "closest"
            this = lambda: ds.closest_cuda(eng, qo, qd, qt)  # noqa: E731
        else:
            km, ka = time_ms(lambda: ds.any_cuda(eng, qo, qd, qt), reps)
            pm, pa = time_plain(lambda r: ds.any_plain(eng, qo[r], qd[r], qt[r]), rows)
            err = check_any(f"stream render shape {name}", ka[rows], pa, qo[rows], qd[rows], qt[rows])
            pub_ms, _ = time_ms(lambda: ds.dense_stream_any_hit(eng, *rays), reps)
            walk_ms, _ = time_ms(lambda: walk.walk_any_hit(walk_eng, *rays), reps)
            wtl = walk._exit_clamp(walk_eng, qo, qd, qt).contiguous()
            wk_ms, _ = time_ms(lambda: walk.any_cuda(walk_eng, qo, qd, wtl), reps)
            print(f"shadow any-hit kernels on the same {nq} rays (pixel order): stream {km:.3f} ms, "
                  f"walk {wk_ms:.3f} ms ({card})")
            need, need_q = (stream_need(ds, walk, eng, w, qo, qd, qt, qt, occ) for w in (ds.CH, ds.QH))
            out_bytes, query = 1, "any"
            this = lambda: ds.any_cuda(eng, qo, qd, qt)  # noqa: E731
        stats = ds.stream_stats(eng, *rays, query=query)
        # the bound counts the need over the 128-row groups the kernels stage
        bms, by = bound_ms(need_q[0] * FLOPS[key],
                           nq * (28 + out_bytes) + need_q[2] * 48 + need_q[1] * 24)
        blocks, lanes = max(stats["blocks"], 1), max(stats["lanes"], 1)
        results[name] = {"key": key, "ms": km, "plain_ms": pm, "bound_ms": bms, "bound_by": by,
                         "rays": nq, "plain_rays": rows.numel(), "err": err, "stats": stats,
                         "tested_pairs": stats["pairs"], "needed_pairs": need_q[0],
                         "needed_pairs_512": need[0], "public_ms": pub_ms, "walk_ms": walk_ms}
        print(f"stream {name}: pairs tested {stats['pairs']}, needed {need[0]} over 512-row chunks "
              f"(tested / needed {stats['pairs'] / max(need[0], 1):.3f}), {need_q[0]} over 128-row "
              f"groups ({stats['pairs'] / max(need_q[0], 1):.3f}); per valid lane: parts entered "
              f"{stats['parts'] / lanes:.2f}, chunks {stats['chunks'] / lanes:.2f}, groups "
              f"{stats['groups'] / lanes:.2f}; groups staged per block {stats['staged'] / blocks:.2f}, "
              f"lanes listed per staged group {stats['listed'] / max(stats['staged'], 1):.2f}; "
              f"{stats['blocks']} blocks, {stats['lanes']} valid lanes")
        per_block = stream_block_groups(ds, eng, qo, qd, qt,
                                        torch.where(ki >= 0, kt, qt) if query == "closest" else qt)
        q = torch.quantile(per_block.double(), torch.tensor([0.5, 0.9, 0.99], device=dev,
                                                            dtype=torch.float64)).tolist()
        print(f"stream {name}: groups entered per block by some valid lane at its least window "
              f"(the cull's model): mean {per_block.double().mean().item():.2f}, median {q[0]:.0f}, "
              f"p90 {q[1]:.0f}, p99 {q[2]:.0f}, max {int(per_block.max())} over {per_block.numel()} "
              f"blocks")
        print(f"time stream {name}: kernel {km:.3f} ms at {nq} rays, plain {pm:.3f} ms at "
              f"{rows.numel()} rays, bound {bms:.4f} ms ({by}) from {need_q[0]} needed pairs in "
              f"{need_q[1]} groups ({card})")
        print(f"A/B {name}: stream public query {pub_ms:.3f} ms, walk public query (sort "
              f"included) {walk_ms:.3f} ms: stream / walk {pub_ms / walk_ms:.2f}")
        for other in (o for o in others if o.stream_closest is not None):
            time_stream_against(f"stream {name} vs {other.label}", other, key, eng, this,
                                (qo, qd, qt), reps, card)
    return results


def render_stream(sh, walk_scene, cam, card):
    """Phase 18: ``PT_WALK=0`` dragon_scene through the CLI at 1 spp, then
    the walk's render of the same sample in process: image means within
    1%."""
    from path_tracer_tpu_torch.integrator.wavefront import render_sample

    os.environ["PT_WALK"] = "0"
    launches, res = render_cli("dragon_scene", 1, card, ("stream_closest", "stream_any", "closest"),
                               absent=("walk_closest", "walk_any"))
    del os.environ["PT_WALK"]
    check(res["engine"] == "stream", res["engine"])
    print(f"dragon_scene PT_WALK=0 bounce steps: {launches['stream_any']} (one any-hit per step)")
    ndc = torch.as_tensor(cam.view_proj_inverse(), device=DEVICE)
    org = torch.as_tensor(cam.origin, device=DEVICE)
    t0 = time.perf_counter()
    rad, _, _, rays = render_sample(
        walk_scene, ndc, org, 0, WIDTH, HEIGHT, max_bounces=MAX_BOUNCES,
        has_lights="light" in walk_scene, spp=1, mtypes=sh.active_mtypes,
        any_volumes=sh.has_volumes)
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    walk_mean = rad.mean().item()
    stream_mean = res["film"][..., :3].mean().item()
    rel = abs(stream_mean - walk_mean) / walk_mean
    print(f"dragon_scene 1 spp through the walk in process: trace {trace_s:.2f} s, "
          f"{float(rays[:, 0].sum()) / trace_s / 1e6:.4f} Mrays/s; image mean {walk_mean:.6f}, "
          f"stream {stream_mean:.6f}: rel diff {rel:.5f} (limit {MEAN_TOL}); trace stream / walk "
          f"{res['trace_s'] / trace_s:.2f} ({card})")
    check(rel <= MEAN_TOL, rel)
    return launches


def phase_probes(card, others=()):
    """Phase 20: the gather probes through their entry point (with each
    of ``others``' probe kernels beside them), launch counts zeroed just
    before and read just after; returns their kernel rows."""
    from path_tracer_tpu_torch.probes import gather

    LAUNCHES = zero_launches()
    out = gather.run(others=[o.probe for o in others if o.probe is not None])
    launches = dict(LAUNCHES)
    print(f"probe launches {launches} ({card})")
    check(launches["row_gather"] > 0 and launches["tile_gather"] > 0, launches)
    r, w = out["rows"], out["tiles"][f"sublane wave {gather.WAVE}"]
    rows = {}
    for key, nbytes, t, plain_ms, nq in (
            ("row_gather", r["bytes"], r["kernel"], r["plain"]["ms"], r["rows"]),
            ("tile_gather", w["bytes"], w, w["plain_ms"], w["lanes"])):
        bms, by = bound_ms(0.0, nbytes)
        rows[key] = {"plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "rays": nq,
                     "plain_rays": nq, "launches": launches[key],
                     **{k: t[k] for k in ("ms", "library_ms", "issue_ms", "library_issue_ms",
                                          "host_issue_ms", "library_host_issue_ms", "floor_ms")}}
        print(f"{key}: device-only {t['ms'] * 1e3:.2f} us ({t['library_ms'] * 1e3:.2f} us the "
              f"library's), issue-inclusive {t['issue_ms'] * 1e3:.2f} us "
              f"({t['library_issue_ms'] * 1e3:.2f}), host issue per call "
              f"{t['host_issue_ms'] * 1e3:.2f} us ({t['library_host_issue_ms'] * 1e3:.2f}), launch "
              f"floor {t['floor_ms'] * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by}) ({card})")
    return rows


# --- render_film: the pooled work queue and tiles (phase 22) ---


def film_run(label, card, fn, spp):
    """One render, launch counts and bounce steps zeroed just before and
    read just after: ``(radiance [N, 3], rays_total [2] float64, result)``
    with the trace seconds (host clock ending in a synchronize), Mrays/s,
    bounce steps, ``trace_lanes`` calls, the mean radiance per sample and
    the launches."""
    from path_tracer_tpu_torch.integrator import wavefront

    wavefront.STEPS.update(bounce=0, calls=0)
    launches = zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rad, rays = fn()
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    r = {"trace_s": trace_s, "mrays_per_s": float(rays[0]) / trace_s / 1e6,
         "steps": wavefront.STEPS["bounce"], "calls": wavefront.STEPS["calls"],
         "mean": rad.mean().item() / spp, "launches": dict(launches)}
    check(bool(torch.isfinite(rad).all()) and r["mean"] > 0.0, (label, r["mean"]))
    print(f"  {label}: trace {trace_s:.3f} s, {r['mrays_per_s']:.4f} Mrays/s, {r['steps']} bounce "
          f"steps in {r['calls']} trace_lanes calls, mean {r['mean']:.6f} ({card})")
    return rad, rays, r


def phase_film(label, sh, scene, cam, width, height, spp, sweep, card):
    """Phase 22: one scene through ``render_sample`` (pinned lanes, one
    wave), pinned ``render_film`` and pooled ``render_film`` twice, at
    `render_film`'s default tile: pinned bit-equal to ``render_sample``
    (radiance and ray totals), the two pooled renders bit-equal (the
    deterministic flush), pooled within 1% of pinned in mean with equal ray
    totals; then the tile sweep, each tile of ``sweep`` pinned (bit-equal
    to ``render_sample``: full tiles and a remainder) and pooled. Returns
    the results by run."""
    from path_tracer_tpu_torch.integrator import wavefront as wf
    from path_tracer_tpu_torch.trace.traversal import engine_name

    ndc = torch.as_tensor(cam.view_proj_inverse(), device=DEVICE)
    org = torch.as_tensor(cam.origin, device=DEVICE)
    args = dict(max_bounces=MAX_BOUNCES, has_lights="light" in scene, mtypes=sh.active_mtypes,
                any_volumes=sh.has_volumes)
    print(f"{label} {width}x{height} {spp} spp through render_film (engine {engine_name(scene)}, "
          f"default tile {wf.TILE_LANES or 'the whole film'}, default pool {wf.POOL}):")

    def sample():
        rad, _, _, rays = wf.render_sample(scene, ndc, org, 0, width, height, spp=spp, **args)
        return rad, rays.sum(0, dtype=torch.float64)

    def film(pool, tile=None):
        return lambda: wf.render_film(scene, ndc, org, 0, width, height, spp, tile_lanes=tile,
                                      pool=pool, **args)

    res = {}
    ref, ref_rays, res["render_sample"] = film_run("render_sample", card, sample, spp)
    rad, rays, res["pinned"] = film_run("render_film pinned", card, film(False), spp)
    check(torch.equal(rad, ref) and torch.equal(rays, ref_rays), f"{label}: pinned != render_sample")
    pool_a, pool_rays, res["pooled"] = film_run("render_film pooled", card, film(True), spp)
    pool_b, _, res["pooled_again"] = film_run("render_film pooled, again", card, film(True), spp)
    rel = abs(res["pooled"]["mean"] - res["pinned"]["mean"]) / res["pinned"]["mean"]
    diff = ((pool_a - ref).abs() / ref.abs().clamp(min=1e-3)).max().item()
    print(f"  pinned render_film bit-equal to render_sample; pooled runs bit-equal: "
          f"{torch.equal(pool_a, pool_b)}; pooled vs pinned: mean rel diff {rel:.2e} (limit "
          f"{MEAN_TOL}), max pixel rel diff {diff:.2e}, ray totals {pool_rays.tolist()} vs "
          f"{ref_rays.tolist()}; steps {res['pooled']['steps']} vs {res['pinned']['steps']}, trace "
          f"pooled / pinned {res['pooled']['trace_s'] / res['pinned']['trace_s']:.3f} ({card})")
    check(torch.equal(pool_a, pool_b), f"{label}: two pooled renders differ")
    check(rel <= MEAN_TOL and torch.equal(pool_rays, ref_rays), (label, rel, pool_rays, ref_rays))
    rows = [("whole film", res["pinned"], res["pooled"])]
    for tile in sweep:
        rad, _, pin = film_run(f"render_film pinned, tiles of {tile}", card, film(False, tile), spp)
        check(torch.equal(rad, ref), f"{label}: pinned tiles of {tile} != render_sample")
        _, _, pooled = film_run(f"render_film pooled, tiles of {tile}", card, film(True, tile), spp)
        res[f"pinned_{tile}"], res[f"pooled_{tile}"] = pin, pooled
        rows.append((f"tiles of {tile}", pin, pooled))
    print(f"  tile sweep, {label} {width}x{height} {spp} spp ({card}):")
    for name, pin, pooled in rows:
        print(f"    {name}: pinned {pin['trace_s']:.3f} s / {pin['steps']} steps / "
              f"{pin['mrays_per_s']:.4f} Mrays/s; pooled {pooled['trace_s']:.3f} s / "
              f"{pooled['steps']} steps / {pooled['mrays_per_s']:.4f} Mrays/s")
    return res


# --- the two-level gather engine (phase 23) ---


def phase_gather(sh, cam, dev, card):
    """Phase 23: the gather engine (torch ops) on many_instance_scene
    two-level: its closest and any hit against iwalk's kernels on 65,536
    rays (32,768 camera rays of a 256x128 film, 32,768 from inside the box
    in random directions; shadow limits 0.5-1.5x each closest t): hit
    flags, t on every common hit to float32 rounding of the hit point (a
    different instance only at the same t), any-hit flags; the ms per query
    of both engines; then ``PT_IWALK=0`` through the CLI at 256x144, 1 spp
    (no two-level kernel launches) against the same render through vwalk in
    process: image means within 1%."""
    from path_tracer_tpu_torch.integrator.wavefront import render_sample
    from path_tracer_tpu_torch.trace import iwalk, twolevel

    t0 = time.perf_counter()
    geng = sh.twolevel.device(DEVICE, engine="gather")["gather"]
    ieng = sh.twolevel.device(DEVICE, engine="iwalk")["iwalk"]
    torch.cuda.synchronize()
    print(f"gather engine on many_instance_scene two-level: {geng['inst_rows'].shape[0]} instances, "
          f"{geng['blas_packed'].shape[0]} BLAS nodes, {geng['tri_packed'].shape[0]} object tris; "
          f"gather and iwalk tables built in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(2323)
    co, cd = camera_rays(cam, *TWO_CAMERA, dev)
    ro = torch.as_tensor(rng.uniform((-270, 5, -270), (270, 550, 270), (TWO_RANDOM, 3))
                         .astype(np.float32), device=dev)
    o, d = torch.cat([co, ro]), torch.cat([cd, unit_rows(rng, TWO_RANDOM, dev)])
    n = o.shape[0]
    tl = torch.full((n,), math.inf, device=dev)
    g_ms = {}
    g_ms["closest"], gq = time_ms(lambda: twolevel.closest_hit(geng, o, d, tl), 2)
    i_ms = {}
    i_ms["closest"], iq = time_ms(lambda: iwalk.iwalk_closest_hit_shade(ieng, o, d, tl), 5)
    hg, hi = gq[0] >= 0, iq[0] >= 0
    flags = (hg == hi).float().mean().item()
    both = hg & hi
    pscale = torch.maximum(iq[1].abs(), (o + d * iq[1][:, None]).abs().amax(1))
    same_t = ((gq[1] - iq[1]).abs() <= T_REL * pscale)[both]
    other = (gq[4] != iq[6])[both]
    scale = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
    tl_any = torch.where(hi, iq[1] * scale, 1e4)
    g_ms["any"], ga = time_ms(lambda: twolevel.any_hit(geng, o, d, tl_any), 2)
    i_ms["any"], ia = time_ms(lambda: iwalk.iwalk_any_hit(ieng, o, d, tl_any), 5)
    any_flags = (ga == ia).float().mean().item()
    print(f"gather vs iwalk on {n} rays: hit flags equal {flags:.6f} ({int((hg != hi).sum())} "
          f"differ), t within rel {T_REL:g} of the hit point's scale on {int(same_t.sum())} of "
          f"{int(both.sum())} common hits, a different instance on {int(other.sum())} (all at the "
          f"same t: {bool(same_t[other].all())}); any-hit flags equal {any_flags:.6f} "
          f"({int((ga != ia).sum())} differ, occluded {ia.float().mean().item():.3f})")
    print(f"gather engine ms per query on {n} rays: closest {g_ms['closest']:.2f} ms, any "
          f"{g_ms['any']:.2f} ms; iwalk's kernels (with their sort) {i_ms['closest']:.3f} / "
          f"{i_ms['any']:.3f} ms ({card})")
    check(flags >= WINNER_AGREE and any_flags >= WINNER_AGREE and bool(same_t.all()),
          (flags, any_flags, int(same_t.sum()), int(both.sum())))
    del geng, ieng

    os.environ["PT_IWALK"] = "0"
    try:
        _, res = render_cli(
            "many_instance_scene", 1, card, ("closest",), width=256, height=144, two_level=True,
            absent=("vwalk_closest", "vwalk_any", "iwalk_closest", "iwalk_any"))
    finally:
        del os.environ["PT_IWALK"]
    check(res["engine"] == "gather", res["engine"])
    # the same film (same aspect, so the same camera) through vwalk
    vscene = sh.device(DEVICE)
    ndc = torch.as_tensor(cam.view_proj_inverse(), device=DEVICE)
    org = torch.as_tensor(cam.origin, device=DEVICE)
    rad, _, _, _ = render_sample(vscene, ndc, org, 0, 256, 144, max_bounces=MAX_BOUNCES,
                                 has_lights="light" in vscene, spp=1, mtypes=sh.active_mtypes,
                                 any_volumes=sh.has_volumes)
    vwalk_mean = rad.mean().item()
    gather_mean = res["film"][..., :3].mean().item()
    rel = abs(gather_mean - vwalk_mean) / vwalk_mean
    print(f"many_instance_scene --two-level PT_IWALK=0 256x144 1 spp: image mean {gather_mean:.6f}, "
          f"vwalk in process {vwalk_mean:.6f}: rel diff {rel:.5f} (limit {MEAN_TOL}) ({card})")
    check(rel <= MEAN_TOL, rel)
    return g_ms


# --- the stack BVH (light tables above 16,384 triangles) ---


def glow_scene():
    """The Cornell shell plus an emissive icosphere(subdivisions=5): 20,482
    light triangles (the sphere's 20,480 and the ceiling light's 2)."""
    from path_tracer_tpu_torch import scenes
    from path_tracer_tpu_torch.scene import procedural
    from path_tracer_tpu_torch.scene.materials import Emissive
    from path_tracer_tpu_torch.scene.model import Model
    from path_tracer_tpu_torch.scene.scene import Scene

    sp, sn = procedural.icosphere((0.0, 250.0, 0.0), 90.0, 5)
    models = scenes._cornell_shell() + [Model(Emissive((4.0, 3.0, 2.0)), positions=sp, normals=sn)]
    return Scene(models), scenes.cornell_camera()


def phase_light_bvh(dev, card):
    """Phase 21: the 20,482-light-triangle scene through the stack BVH
    light path on the CPU and on the card, then the stack BVH's queries on
    the card over 65,536 rays of its light table, against the CPU's on
    4,096 of them (the same torch ops: the same bits)."""
    from path_tracer_tpu_torch.trace import bvh_stack

    print("Cornell shell + emissive icosphere(subdivisions=5):")
    cross_backend(glow_scene, 32, 32, 2)
    sh, _ = glow_scene()
    scene = sh.device(DEVICE)
    lt = sh.light["pdf"].shape[0]
    check(lt == 20482 and "bvh" in scene["light"] and "dense" not in scene["light"],
          (lt, sorted(scene["light"])))
    tab = scene["light"]["bvh"]
    rng = np.random.default_rng(9753)
    n = 65536
    o = torch.as_tensor(rng.uniform((-270, 5, -270), (270, 550, 270), (n, 3)).astype(np.float32),
                        device=dev)
    toward = light_targets(rng, scene, n, dev) - o
    d = torch.where((torch.arange(n, device=dev) % 2 == 0)[:, None],
                    toward / toward.norm(dim=1, keepdim=True), unit_rows(rng, n, dev)).contiguous()
    tl = torch.full((n,), math.inf, device=dev)
    c_ms, (bi, bt, bu, bv) = time_ms(lambda: bvh_stack.closest_hit(tab, o, d, tl), 3)
    lim = torch.where(bi >= 0, bt * 1.001, 1000.0).contiguous()
    a_ms, fa = time_ms(lambda: bvh_stack.any_hit(tab, o, d, lim), 3)
    sub = torch.arange(0, n, n // 4096, device=dev)
    tab_cpu = {k: v.cpu() for k, v in tab.items()}
    cc = bvh_stack.closest_hit(tab_cpu, o[sub].cpu(), d[sub].cpu(), tl[sub].cpu())
    ca = bvh_stack.any_hit(tab_cpu, o[sub].cpu(), d[sub].cpu(), lim[sub].cpu())
    same = all(torch.equal(x[sub].cpu(), y) for x, y in zip((bi, bt, bu, bv), cc))
    check(same and torch.equal(fa[sub].cpu(), ca), "stack BVH card vs CPU")
    print(f"stack BVH on the {lt}-triangle light table ({tab['nodes'].shape[0]} nodes): closest "
          f"hit {c_ms:.3f} ms and any hit {a_ms:.3f} ms over {n} rays (hits "
          f"{(bi >= 0).float().mean().item():.3f}, occluded {fa.float().mean().item():.3f}); "
          f"card equal to CPU on {sub.numel()} rays ({card})")


# --- the interactive frame (phase 24) ---

FRAME_SCENES = ("cornell_specular", "cornell_volume", "mesh_scene")
FRAMES = 8  # timed session frames per static run, after one warm frame
MOVING_FRAMES = 3  # and per moving run (8 put phase 24 over its ~120 s)
OTHER_FRAMES = 2  # timed frames of the monolithic and count-driven schedules
TAA_RTOL, TAA_ATOL = 1e-5, 1e-6  # the float TAA stages, card against CPU
U8_EDGE = 1e-3  # display_frame_u8: a value this close to a .5 step may round either way
# (stage, inputs) of phase 24's TAA check
TAA_STAGES = (
    ("accumulate", ("acc", "colour")), ("w_divide", ("acc",)),
    ("compute_velocity", ("position", "wtc")), ("_rgb_to_ycocg", ("q",)),
    ("_ycocg_to_rgb", ("q",)), ("_clip_aabb", ("lo", "hi", "q")), ("_bilinear", ("acc", "uv")),
    ("_sample_catmull_rom", ("acc", "uv")),
    ("temporal_reproject", ("colour", "acc", "velocity", "ids")), ("display_frame", ("acc",)),
    ("pack_ids", ("prev_ids", "new_id")),
    ("frame_update_static", ("prev_ids", "acc", "colour", "new_id")),
    ("frame_update_moving", ("prev_ids", "acc", "colour", "new_id", "position", "wtc")),
)


@contextlib.contextmanager
def patched(obj, **attrs):
    """Set attributes of a module for the duration of a block."""
    old = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


def taa_inputs(h, w):
    """Numpy-seeded TAA inputs at h x w (ids: uint32 bits in int64)."""
    from path_tracer_tpu_torch import scenes

    rs = np.random.default_rng(24)
    colour = np.concatenate([rs.uniform(0, 2, (h, w, 3)), rs.uniform(0.5, 2, (h, w, 1))], -1)
    acc = np.concatenate([rs.uniform(0, 8, (h, w, 3)), rs.integers(1, 9, (h, w, 1))], -1)
    pos = np.concatenate([rs.uniform(-300, 300, (h, w, 2)), rs.uniform(-800, 300, (h, w, 1)),
                          rs.uniform(1, 900, (h, w, 1))], -1)
    lo = rs.uniform(-1, 0, (h, w, 3))
    hi = lo + rs.uniform(0, 1, (h, w, 3)) * (rs.uniform(size=(h, w, 1)) > 0.1)
    f32 = {"colour": colour, "acc": acc, "velocity": rs.uniform(-0.2, 0.2, (h, w, 2)),
           "position": pos, "uv": rs.uniform(-0.1, 1.1, (h, w, 2)), "lo": lo, "hi": hi,
           "q": rs.uniform(-2, 2, (h, w, 3)),
           "wtc": scenes.cornell_camera(aspect=w / h).world_to_clip()}
    out = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in f32.items()}
    out["ids"] = torch.from_numpy(rs.integers(0, 4, (h, w)) << 16 | rs.integers(0, 4, (h, w)))
    out["prev_ids"] = torch.from_numpy(rs.integers(0, 2**32, (h, w), dtype=np.int64))
    out["new_id"] = torch.from_numpy(rs.integers(0, 2**32, (h, w), dtype=np.int64))
    return out


def phase_taa(card):
    """Phase 24a: every TAA stage at 1024x576 on the card against the CPU on
    the same inputs: float stages within TAA_RTOL / TAA_ATOL, ids equal,
    ``display_frame_u8`` equal but where the CPU's value lies within
    U8_EDGE of a .5 step."""
    from path_tracer_tpu_torch.interactive import taa

    inp = taa_inputs(HEIGHT, WIDTH)
    gpu_inp = {k: v.to(DEVICE) for k, v in inp.items()}
    worst = 0.0
    for name, args in TAA_STAGES:
        fn = getattr(taa, name)
        cpu = fn(*[inp[a] for a in args])
        t_ms, gpu = time_ms(lambda: fn(*[gpu_inp[a] for a in args]), 5)  # noqa: B023
        pairs = zip(cpu, gpu) if isinstance(cpu, tuple) else [(cpu, gpu)]
        errs = []
        for c, g in pairs:
            g = g.cpu()
            if c.dtype.is_floating_point:
                check(torch.allclose(g, c, rtol=TAA_RTOL, atol=TAA_ATOL), f"TAA {name}: card vs CPU")
                errs.append((g - c).abs().max().item())
            else:
                check(torch.equal(g, c), f"TAA {name}: card ids vs CPU")
                errs.append(0.0)
        worst = max(worst, *errs)
        print(f"  TAA {name} {WIDTH}x{HEIGHT}: card {t_ms:.3f} ms, max |card - CPU| {max(errs):.3g}")
    f = taa.display_frame(inp["acc"]) * 255.0
    edge = ((f - torch.floor(f)) - 0.5).abs() < U8_EDGE
    diff = taa.display_frame_u8(gpu_inp["acc"]).cpu() != taa.display_frame_u8(inp["acc"])
    print(f"  TAA display_frame_u8: {int(diff.sum())} of {diff.numel()} values differ, all within "
          f"{U8_EDGE} of a .5 step ({int(edge.sum())} such values) ({card})")
    check(not bool((diff & ~edge).any()), "display_frame_u8: card vs CPU off a .5 step")
    return worst


def counted(fn):
    """``(fn(), seconds, bounce steps, trace_lanes calls, host reads,
    launches)`` with the counts zeroed just before and read just after."""
    from path_tracer_tpu_torch.integrator import wavefront

    wavefront.STEPS.update(bounce=0, calls=0, reads=0)
    launches = zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, wavefront.STEPS["bounce"], wavefront.STEPS["calls"],
            wavefront.STEPS["reads"], dict(launches))


def phase_segmented(card):
    """Phase 24b: `render_sample_segmented` against `render_sample` at
    1024x576, 64 bounces, on cornell_specular and cornell_volume, samples 0
    and 3: count-driven, then predicted over 4 frames of one predictor
    (samples 0, 3, 0, 3): radiance, position, first id and rays bit-equal."""
    from path_tracer_tpu_torch import scenes
    from path_tracer_tpu_torch.integrator import wavefront as wf

    for name in ("cornell_specular", "cornell_volume"):
        sh, cam = getattr(scenes, name)(aspect=WIDTH / HEIGHT)
        scene = sh.device(DEVICE)
        ndc = torch.as_tensor(cam.view_proj_inverse(), device=DEVICE)
        org = torch.as_tensor(cam.origin, device=DEVICE)
        args = dict(max_bounces=MAX_BOUNCES, has_lights="light" in scene, mtypes=sh.active_mtypes,
                    any_volumes=sh.has_volumes)
        print(f"{name} {WIDTH}x{HEIGHT}, 1 spp, {MAX_BOUNCES} bounces, segmented against "
              f"render_sample (caps {wf._seg_caps(WIDTH * HEIGHT)}):")

        def run(label, fn, sid, ref=None, **kw):
            """``fn``'s render of sample ``sid``, counted, printed and (with
            ``ref``) held bit-equal to it."""
            r = counted(lambda: fn(scene, ndc, org, sid, WIDTH, HEIGHT, **args, **kw))
            if ref is not None:
                check(all(torch.equal(a, b) for a, b in zip(r[0], ref)),
                      f"{name} sample {sid}: {label} != render_sample")
            print(f"  {label}, sample {sid}{': bit-equal' if ref else ''}: {r[1]:.3f} s, {r[2]} "
                  f"steps, {r[3]} segments, {r[4]} host reads, dense closest / any "
                  f"{r[5]['closest']} / {r[5]['any']}")
            return r[0]

        refs = {sid: run("render_sample", wf.render_sample, sid) for sid in (0, 3)}
        with patched(wf, _SEG_PREDICT=True):
            # sample 0 count-driven: the predictor's first frame, below
            run("count-driven segmented", wf.render_sample_segmented, 3, refs[3])
            pred = wf.SegmentPredictor()
            for i, sid in enumerate((0, 3, 0, 3)):
                kind = "count-driven, seeds the plan" if i == 0 else "predicted"
                run(f"frame {i} of one predictor ({kind})", wf.render_sample_segmented, sid,
                    refs[sid], predictor=pred)
            print(f"  overflows over the 4 frames: {pred.overflows}")
            check(pred.overflows == 0, f"{name}: a predicted frame overflowed its plan")
        del scene
    print(f"  ({card})")


def session_run(label, sh, cam, mode, frames, card):
    """One `InteractiveRenderer` at 1024x576: one warm frame, then
    ``frames`` timed frames, each ending in ``display(as_uint8=True)``;
    ``mode`` "moving" orbits and strafes each frame as the JAX fps bench
    does (``benches/interactive_fps.py:42-48``). Launch and step counts
    are zeroed just before each frame and read just after; every frame
    must launch the dense closest and any hit. Returns the run's numbers."""
    import copy

    from path_tracer_tpu_torch.integrator import wavefront as wf
    from path_tracer_tpu_torch.interactive import session, taa

    r = session.InteractiveRenderer(sh, copy.deepcopy(cam), WIDTH, HEIGHT,
                                    max_bounces=MAX_BOUNCES, device=DEVICE)
    split = {"trace": 0.0, "taa": 0.0, "display": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            return out
        return run

    def step(i):
        if mode == "moving":
            r.mouse(2e-4 if i % 2 == 0 else -1.5e-4, 1e-4, 1.0 / 60.0)
            r.key("w" if i % 4 < 2 else "d", 6e-6)
        r.frame()
        t0 = time.perf_counter()
        img = r.display(as_uint8=True)
        split["display"] += time.perf_counter() - t0
        return img

    per = {"steps": [], "segments": [], "reads": [], "closest": [], "any": []}
    with patched(session, render_sample_segmented=timed("trace", session.render_sample_segmented),
                 render_sample=timed("trace", session.render_sample)), \
            patched(taa, frame_update_static=timed("taa", taa.frame_update_static),
                    frame_update_moving=timed("taa", taa.frame_update_moving)):
        step(0)
        for k in split:
            split[k] = 0.0
        over0 = r._predictor.overflows
        total = 0.0
        for i in range(1, frames + 1):
            (img, sec, steps, calls, reads, launches) = counted(lambda: step(i))  # noqa: B023
            total += sec
            for k, v in (("steps", steps), ("segments", calls), ("reads", reads),
                         ("closest", launches["closest"]), ("any", launches["any"])):
                per[k].append(v)
            check(launches["closest"] > 0 and launches["any"] > 0,
                  f"{label}: frame {i} launched no dense kernel: {launches}")
            check(img.shape == (HEIGHT, WIDTH, 3) and img.dtype == np.uint8 and img.any(),
                  f"{label}: frame {i} image")
    res = {"fps": frames / total, "ms": 1e3 * total / frames,
           **{k: 1e3 * v / frames for k, v in split.items()},
           **{k: sum(v) / frames for k, v in per.items()},
           "overflows": r._predictor.overflows - over0}
    rng = lambda k: f"{min(per[k])}-{max(per[k])}"  # noqa: E731
    print(f"  {label}: {res['fps']:.3f} frames/s, {res['ms']:.1f} ms/frame (trace "
          f"{res['trace']:.1f}, TAA {res['taa']:.2f}, display {res['display']:.2f} ms); per frame: "
          f"steps {res['steps']:.1f} ({rng('steps')}), segments {res['segments']:.1f}, host reads "
          f"{res['reads']:.1f}, dense closest {rng('closest')}, any {rng('any')}; overflows "
          f"{res['overflows']} in {frames} frames ({card})")
    return res


# the frame schedules (label, module, attributes set for the run)
SCHEDULES = (("monolithic (PT_INTERACTIVE_SEG=0)", "session", {"_SEGMENTED": False}),
             ("count-driven", "wavefront", {"_SEG_PREDICT": False}),
             ("predicted", "wavefront", {"_SEG_PREDICT": True}))


def run_schedule(card, sh, cam, schedule, frames):
    """One static `session_run` under ``schedule`` (an entry of SCHEDULES);
    returns its ms per frame."""
    from path_tracer_tpu_torch.integrator import wavefront
    from path_tracer_tpu_torch.interactive import session

    label, mod, attrs = schedule
    with patched({"session": session, "wavefront": wavefront}[mod], **attrs):
        return session_run(f"  {label}", sh, cam, "static", frames, card)["ms"]


def phase_schedule_ab(card, sh, cam, frames, rounds):
    """The frame schedules of SCHEDULES on one scene, static, in turns:
    each round runs every schedule (one warm frame, then ``frames`` timed),
    the order reversed every other round; prints each schedule's ms per
    frame by round and their median. Not part of the default run: a
    verdict needs many rounds (frames spread by about 30%)."""
    print(f"  schedule A/B, static, {rounds} round(s) of {frames} frames each after a warm frame:")
    ms = {label: [] for label, _, _ in SCHEDULES}
    for k in range(rounds):
        for sched in (SCHEDULES if k % 2 == 0 else SCHEDULES[::-1]):
            ms[sched[0]].append(run_schedule(card, sh, cam, sched, frames))
    for label, v in ms.items():
        print(f"    {label}: ms/frame by round {[round(x, 1) for x in v]}, median "
              f"{float(np.median(v)):.1f} ({card})")
    return ms


def phase_interactive(card):
    """Phase 24: the interactive frame on the card (24a TAA, 24b segmented,
    then the sessions, and the monolithic and count-driven schedules on
    cornell_specular static beside the default's run)."""
    from path_tracer_tpu_torch import scenes
    from path_tracer_tpu_torch.integrator import wavefront as wf
    from path_tracer_tpu_torch.interactive import session

    t0 = time.perf_counter()
    print(f"interactive frame: TAA stages, card against CPU ({WIDTH}x{HEIGHT}):")
    phase_taa(card)
    phase_segmented(card)
    print(f"InteractiveRenderer {WIDTH}x{HEIGHT}, {MAX_BOUNCES} bounces (PT_INTERACTIVE_SEG "
          f"{int(session._SEGMENTED)}, PT_SEG_PREDICT {int(wf._SEG_PREDICT)}):")
    hosts, res = {}, {}
    for name in FRAME_SCENES:
        hosts[name] = getattr(scenes, name)(aspect=WIDTH / HEIGHT)
        for mode in ("static", "moving"):
            res[name, mode] = session_run(f"{name} {mode}", *hosts[name], mode,
                                          FRAMES if mode == "static" else MOVING_FRAMES, card)
    print(f"cornell_specular static, other schedules, {OTHER_FRAMES} frames each (one reading "
          f"beside the default's {res['cornell_specular', 'static']['ms']:.1f} ms/frame above):")
    for sched in SCHEDULES[:2]:
        res[sched[0]] = run_schedule(card, *hosts["cornell_specular"], sched, OTHER_FRAMES)
    print(f"phase 24: {time.perf_counter() - t0:.1f} s")
    return res


# --- multi-card rendering (phase 25) ---

SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-6  # tile-sharded and sharded frames against one process
SPP_RTOL = 1e-6  # spp-sharded sums against the sequential samples
# (case, scene) of the sharded runs: (a) runs the first two in a group of one
SHARD_CASES = (("tile", "mesh_scene"), ("spp", "mesh_scene"), ("tile", "many_instance_scene"),
               ("frames", "cornell_specular"), ("session", "cornell_specular"))
SHARD_FILMS = {"mesh_scene": (WIDTH, HEIGHT), "many_instance_scene": (MANY_W, MANY_H),
               "cornell_specular": (WIDTH, HEIGHT)}
SHARD_KERNELS = {"mesh_scene": ("closest", "any"), "cornell_specular": ("closest", "any"),
                 "many_instance_scene": ("vwalk_closest", "vwalk_any")}
SHARD_FRAMES = 2  # sharded frames of one predictor: count-driven, then predicted


def shard_hosts():
    """Phase 25's host scenes by name (many_instance_scene two-level)."""
    from path_tracer_tpu_torch import scenes

    return {name: getattr(scenes, name)(aspect=w / h, two_level=name == "many_instance_scene")
            for name, (w, h) in SHARD_FILMS.items()}


@contextlib.contextmanager
def timed_collectives(times):
    """Time every ``all_gather``, ``all_reduce`` and ``broadcast`` (host
    clock between synchronizations of this rank's card) into
    ``times[name]`` (ms)."""
    import torch.distributed as dist

    def wrap(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    with patched(dist, all_gather=wrap("all_gather", dist.all_gather),
                 all_reduce=wrap("all_reduce", dist.all_reduce),
                 broadcast=wrap("broadcast", dist.broadcast)):
        yield


def warm_up(hosts, dev, scenes_on, render, gather=None):
    """An untimed mesh_scene render at 64x32, 4 bounces (and a gather of
    it): the kernels' libraries, the allocator and a group's first
    collective (NCCL sets its communicator up there) start before any
    timing. Uploads mesh_scene into ``scenes_on``."""
    sh, cam = hosts["mesh_scene"]
    scenes_on["mesh_scene"] = scene = sh.device(dev)
    out = render(scene, torch.as_tensor(cam.view_proj_inverse(), device=dev),
                 torch.as_tensor(cam.origin, device=dev), 0, 64, 32, max_bounces=4,
                 mtypes=sh.active_mtypes, any_volumes=sh.has_volumes)[0]
    if gather is not None:
        gather(out)
    torch.cuda.synchronize()


def session_moves(r, lead):
    """Phase 25's session input: a static frame, then (``lead``: the rank
    or process that takes the input) a mouse move and a step forward and a
    frame on the TAA path. Returns (accumulation, ids)."""
    r.frame()
    if lead:
        r.mouse(2e-4, 1e-4, 1.0 / 60.0)
        r.key("w", 6e-6)
    r.frame()
    return r.accumulation, r.ids


def shard_run(hosts, dev, cases):
    """Phase 25's ``cases`` as one rank of the default group on ``dev``:
    per case this rank's trace seconds (its collectives' time taken out),
    the ms of each all_gather, all_reduce and broadcast, the launches of the case's
    kernels (zeroed just before, read just after; each must be > 0), and
    on rank 0 the gathered outputs on the host: tile (radiance, rays),
    spp (the all-reduced sum), frames (radiance and first ids of each),
    session (rank 0's accumulation and ids after `session_moves`)."""
    import copy

    import torch.distributed as dist

    from path_tracer_tpu_torch.interactive.session import InteractiveRenderer

    from path_tracer_tpu_torch.integrator import wavefront as wf
    from path_tracer_tpu_torch.parallel import mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    scenes_on = {}
    res = {}
    warm_up(hosts, dev, scenes_on, mesh.render_sample_sharded, mesh.gather_lanes)
    for case, name in cases:
        sh, cam = hosts[name]
        if name not in scenes_on:
            scenes_on[name] = sh.device(dev)
        scene = scenes_on[name]
        w, h = SHARD_FILMS[name]
        ndc = torch.as_tensor(cam.view_proj_inverse(), device=dev)
        org = torch.as_tensor(cam.origin, device=dev)
        kw = dict(max_bounces=MAX_BOUNCES, has_lights="light" in scene, mtypes=sh.active_mtypes,
                  any_volumes=sh.has_volumes)
        if case == "session":
            sess = InteractiveRenderer(sh, copy.deepcopy(cam), w, h, max_bounces=MAX_BOUNCES,
                                       device=dev, group=dist.group.WORLD)
        times = {"all_gather": [], "all_reduce": [], "broadcast": []}
        LAUNCHES = zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timed_collectives(times):
            if case == "tile":
                rad, rays = mesh.render_sample_sharded(scene, ndc, org, 0, w, h, **kw)
                out = mesh.gather_lanes(torch.cat([rad, rays], dim=1))
                out = (out[:, :3], out[:, 3:])
            elif case == "spp":
                out = (mesh.render_spp_sharded(scene, ndc, org, 0, w, h, spp=2 // world or 1,
                                               **kw),)
            elif case == "session":
                out = session_moves(sess, rank == 0)
            else:
                pred = wf.SegmentPredictor()
                out = ()
                for sid in range(SHARD_FRAMES):
                    rad, _, fid, _ = mesh.frame_segmented_sharded(scene, ndc, org, sid, w, h,
                                                                  predictor=pred, **kw)
                    out += (rad, fid)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in SHARD_KERNELS[name]}
        check(all(v > 0 for v in launches.values()),
              f"rank {rank} {case} {name}: no kernel launch {launches}")
        res[case, name] = {
            "trace_s": seconds - 1e-3 * sum(sum(v) for v in times.values()),
            **times, "launches": launches,
            "out": tuple(x.cpu() for x in out) if rank == 0 else None,
        }
        del out
    return res


def shard_rank(i, world, store, out_dir, backend, same_card, hosts, cases):
    """A spawned rank of phase 25 (b) / (c): join the group through the
    FileStore at ``store`` (rank ``i`` on cuda:0 with ``same_card``, else
    on cuda:i), run ``cases``, save its results to ``out_dir``."""
    import torch.distributed as dist

    from path_tracer_tpu_torch.parallel.mesh import make_group

    dev = make_group(f"cuda:{0 if same_card else i}", backend=backend,
                     store=dist.FileStore(store, world), rank=i, world_size=world)
    try:
        res = shard_run(hosts, dev, cases)
    finally:
        dist.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{i}.pt")


def hold_sharded(label, res, refs, world):
    """Hold rank 0's gathered outputs of each case against the
    single-process ``refs``, and print every rank's numbers beside the
    one-process seconds."""
    for key, r0 in res[0].items():
        case, name = key
        got = r0["out"]
        samples = {"tile": 1, "spp": world * (2 // world or 1), "frames": SHARD_FRAMES,
                   "session": 0}[case]
        if case == "tile":
            want = refs["sample", name, 0]
            diff = int((got[0] != want[0]).any(dim=1).sum())
            err = (got[0] - want[0]).abs().max().item()
            ok = torch.allclose(got[0], want[0], rtol=SHARD_RTOL, atol=SHARD_ATOL)
            what = (f"{diff} of {want[0].shape[0]} lanes differ at all, max |diff| {err:.3g}, "
                    f"rays {got[1][:, 0].sum().item():.0f} against "
                    f"{want[1][:, 0].sum().item():.0f}")
        elif case == "spp":
            per = 2 // world or 1
            want = torch.zeros_like(got[0])
            for s in range(samples):
                want[:, :3] += refs["sample", name, s][0]
            want[:, 3] = samples
            err = ((got[0] - want).abs() / want.abs().clamp(min=1e-30)).max().item()
            ok = torch.allclose(got[0], want, rtol=SPP_RTOL, atol=0.0)
            what = (f"{world} rank(s) x {per} spp against {samples} sequential samples: "
                    f"max rel diff {err:.3g}")
        elif case == "session":
            acc, ids = refs["session"][:2]
            diff = int((got[0] != acc).any(dim=-1).sum())
            ok = (torch.allclose(got[0], acc, rtol=SHARD_RTOL, atol=SHARD_ATOL)
                  and torch.equal(got[1], ids))
            what = (f"2 frames (the second moved, input on rank 0 only): {diff} pixels of the "
                    f"accumulation differ, ids {'equal' if torch.equal(got[1], ids) else 'DIFFER'}"
                    f" (against one process's session)")
        else:
            oks, what = [], []
            for f in range(SHARD_FRAMES):
                want = refs["sample", name, f]
                rad, fid = got[2 * f], got[2 * f + 1]
                diff = int((rad != want[0]).any(dim=1).sum())
                oks.append(torch.allclose(rad, want[0], rtol=SHARD_RTOL, atol=SHARD_ATOL)
                           and torch.equal(fid, want[2]))
                what.append(f"frame {f} ({'predicted' if f else 'count-driven'}): {diff} lanes "
                            f"differ, ids {'equal' if torch.equal(fid, want[2]) else 'DIFFER'}")
            ok, what = all(oks), "; ".join(what)
        w, h = SHARD_FILMS[name]
        one = (refs["session"][2] if case == "session"
               else sum(refs["seconds", name, k] for k in range(samples)))
        ranks = ", ".join(
            f"rank {k}: trace {r[key]['trace_s']:.3f} s, all_gather "
            f"{[round(x, 2) for x in r[key]['all_gather']]} ms, all_reduce "
            f"{[round(x, 2) for x in r[key]['all_reduce']]} ms, "
            + (f"broadcast {[round(x, 2) for x in r[key]['broadcast']]} ms, "
               if r[key]["broadcast"] else "")
            + f"launches {r[key]['launches']}"
            for k, r in enumerate(res))
        skew = max(r[key]["trace_s"] for r in res) - min(r[key]["trace_s"] for r in res)
        print(f"  {label} {case} {name} {w}x{h}: {what}; {ranks}; rank skew {skew:.3f} s; one "
              f"process, the same work: {one:.3f} s")
        check(ok, f"phase 25 {label} {case} {name}: sharded against one process")


def phase_sharded(card):
    """Phase 25: multi-card rendering (``parallel/mesh.py``). First
    ``cli --multichip`` (a rank on each visible card) against
    ``render_sample``; (a) a group of one over NCCL in this process:
    tile-sharded mesh_scene 1 spp against ``render_sample``, spp-sharded 2
    spp against the sum of two sequential samples; (b) two ranks on this
    card over gloo (NCCL refuses two ranks on one card; chosen here, not a
    fallback): tile and spp (2 x 1 spp) mesh_scene, tile-sharded
    many_instance_scene --two-level at 1920x1080 (config 5's film, vwalk),
    2 sharded frames of cornell_specular (the second predicted) and a
    2-frame sharded session on it (`session_moves`: rank 0 alone takes the
    input, the others get it by the frame's broadcast), each against this
    process's single-process result on the same card; (c) with two cards
    or more, (b) over NCCL with a rank on each card."""
    import copy
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from path_tracer_tpu_torch import cli
    from path_tracer_tpu_torch.interactive.session import InteractiveRenderer
    from path_tracer_tpu_torch.integrator import wavefront as wf
    from path_tracer_tpu_torch.parallel.mesh import make_group

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    hosts = shard_hosts()
    refs, scenes_on = {}, {}
    warm_up(hosts, DEVICE, scenes_on, wf.render_sample)
    for name, (sh, cam) in hosts.items():
        w, h = SHARD_FILMS[name]
        scene = scenes_on.pop(name, None) or sh.device(DEVICE)
        ndc = torch.as_tensor(cam.view_proj_inverse(), device=DEVICE)
        org = torch.as_tensor(cam.origin, device=DEVICE)
        samples = {"mesh_scene": max(2, n_cards), "cornell_specular": SHARD_FRAMES}.get(name, 1)
        for s in range(samples):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rad, _, fid, rays = wf.render_sample(
                scene, ndc, org, s, w, h, max_bounces=MAX_BOUNCES, has_lights="light" in scene,
                mtypes=sh.active_mtypes, any_volumes=sh.has_volumes)
            torch.cuda.synchronize()
            refs["seconds", name, s] = time.perf_counter() - t0
            refs["sample", name, s] = (rad.cpu(), rays.cpu(), fid.cpu())
        del scene
    sh, cam = hosts["cornell_specular"]
    r = InteractiveRenderer(sh, copy.deepcopy(cam), *SHARD_FILMS["cornell_specular"],
                            max_bounces=MAX_BOUNCES, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, ids = session_moves(r, True)
    torch.cuda.synchronize()
    refs["session"] = (acc.cpu(), ids.cpu(), time.perf_counter() - t0)
    del r
    print(f"multi-card rendering: one-process references {time.perf_counter() - t_phase:.1f} s "
          f"({n_cards} card(s))")

    LAUNCHES = zero_launches()
    t0 = time.perf_counter()
    res = cli.main(["--scene", "mesh_scene", "--width", str(WIDTH), "--height", str(HEIGHT),
                    "--spp", "1", "--max-bounces", str(MAX_BOUNCES), "--device", DEVICE,
                    "--out", str(OUT_DIR / "smoke_multichip.png"), "--multichip"])
    seconds = time.perf_counter() - t0
    want = refs["sample", "mesh_scene", 0][0]
    got = res["film"][..., :3].reshape(-1, 3).cpu()
    diff = int((got != want).any(dim=1).sum())
    print(f"  cli --multichip mesh_scene {WIDTH}x{HEIGHT} 1 spp, {res['ranks']} rank(s): "
          f"{seconds:.2f} s end to end, trace {res['trace_s']:.3f} s, {diff} lanes differ from "
          f"render_sample, rank 0 launches closest / any {LAUNCHES['closest']} / {LAUNCHES['any']}")
    check(res["ranks"] == n_cards and LAUNCHES["closest"] > 0 and LAUNCHES["any"] > 0,
          f"cli --multichip: {res['ranks']} ranks, launches {dict(LAUNCHES)}")
    check(torch.allclose(got, want, rtol=SHARD_RTOL, atol=SHARD_ATOL), "cli --multichip film")

    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        dev = make_group(DEVICE, store=dist.FileStore(f"{tmp}/a", 1), rank=0, world_size=1)
        try:
            res_a = shard_run(hosts, dev, SHARD_CASES[:2])
        finally:
            dist.destroy_process_group()
    hold_sharded("(a) NCCL, 1 rank", [res_a], refs, 1)
    torch.cuda.empty_cache()

    runs = [("(b) gloo, 2 ranks on cuda:0", 2, "gloo", True)]
    if n_cards >= 2:
        runs.append((f"(c) NCCL, {n_cards} ranks on {n_cards} cards", n_cards, "nccl", False))
    for label, world, backend, same in runs:
        with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
            t0 = time.perf_counter()
            mp.start_processes(shard_rank, args=(world, f"{tmp}/store", tmp, backend, same, hosts,
                                                 SHARD_CASES), nprocs=world, start_method="spawn")
            res_b = [torch.load(Path(tmp) / f"rank{k}.pt") for k in range(world)]
        print(f"  {label}: {time.perf_counter() - t0:.1f} s with the processes' start")
        hold_sharded(label, res_b, refs, world)
    if n_cards < 2:
        print(f"  (c) not run: {n_cards} card visible")
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s ({card})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, nargs="+", default=[],
                    help="csrc directories of a parent commit (or variants of it): time their dense, "
                         "walk, vwalk, iwalk, stream and probe kernels "
                         "beside this tree's (phases 3, 7, 12, 17 and 20), each whose source "
                         "differs from this tree's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"card: {card}")
    t_start = time.perf_counter()

    from path_tracer_tpu_torch import native, scenes
    from path_tracer_tpu_torch.trace import cuda_lib
    from path_tracer_tpu_torch.trace import dense_cuda as dc
    from path_tracer_tpu_torch.trace import dense_stream as ds
    from path_tracer_tpu_torch.trace import iwalk, walk

    t0 = time.perf_counter()
    finish_others = start_other_builds(args.parent)
    host = threading.Thread(target=native.available)  # g++, beside the nvcc builds
    host.start()
    libs = cuda_lib.build("dense_hit", "walk_hit", "iwalk_hit", "dense_stream", "gather_probe")
    host.join()
    check(native.available(), "the native host builder did not build (g++)")
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(p.name for p in libs)}, "
          f"{native.lib_path().name})")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if ptxas_line(line):
                print(f"  ptxas {lib.name}:", line.strip())
    others = finish_others()
    if others:
        print(f"--parent builds: {time.perf_counter() - t0:.1f} s")
    dev = torch.device(DEVICE)

    sh, cam = scenes.mesh_scene(aspect=WIDTH / HEIGHT)
    mesh = sh.device(DEVICE)
    errs, dense_t = phase_dense(dc, walk, mesh, cam, dev, card, others)
    dense_launches, _ = render_cli("mesh_scene", SPP, card, ("closest", "any"))
    t0 = time.perf_counter()
    film_t = {"mesh": phase_film("mesh_scene", sh, mesh, cam, WIDTH, HEIGHT, SPP, FILM_TILES, card)}
    del mesh
    print(f"phase 22 (mesh_scene): {time.perf_counter() - t0:.1f} s")
    print("cornell_specular:")
    # 64x64 until the stream phases came, 4 spp until phases 22-23 came
    cross_backend(scenes.cornell_specular, 32, 32, 2)

    t0 = time.perf_counter()
    sh, cam = scenes.dragon_scene(aspect=WIDTH / HEIGHT)
    t1 = time.perf_counter()
    scene = sh.device(DEVICE)
    torch.cuda.synchronize()
    print(f"dragon_scene: {sh.num_world_tris} world tris, scene build {t1 - t0:.1f} s, "
          f"upload with walk packing {time.perf_counter() - t1:.1f} s")
    walk_errs, walk_t = phase_walk(walk, scene, cam, dev, card, others)
    errs.update(walk_errs)
    walk_eng = scene["tri"]["walk"]  # phases 16-18 and 11 hold other engines against it
    print(f"phases 6-7: {time.perf_counter() - t0:.1f} s")
    # the CLI renders of phases 8 and 18 take phase 6's host scene (its
    # NumPy SAH build is 60-100 s of host time, printed above)
    with prebuilt_dragon(scenes, sh, cam):
        walk_launches, res = render_cli("dragon_scene", DRAGON_SPP, card,
                                        ("walk_closest", "walk_any", "closest"))
    print(f"dragon_scene bounce steps: {walk_launches['walk_any']} (one any-hit per step)")
    t0 = time.perf_counter()
    film_t["dragon"] = phase_film("dragon_scene", sh, scene, cam, WIDTH, HEIGHT, DRAGON_SPP,
                                  FILM_TILES, card)
    print(f"phase 22 (dragon_scene): {time.perf_counter() - t0:.1f} s")
    print("dragon_scene(nu=96, nv=64, env_h=64):")
    cross_backend(lambda: scenes.dragon_scene(nu=96, nv=64, env_h=64), 32, 32, 2)  # 4 until 22-23

    t0 = time.perf_counter()
    stream_scene = sh.device(DEVICE, engine="stream")
    torch.cuda.synchronize()
    print(f"dragon_scene upload with stream packing {time.perf_counter() - t0:.1f} s")
    seng = stream_scene["tri"]["stream"]
    errs.update(phase_stream(ds, dc, walk, seng, walk_eng, cam, dev, card))
    stream_t = phase_stream_shapes(ds, dc, walk, seng, walk_eng, stream_scene, cam, dev, card,
                                   others)
    for r in stream_t.values():
        errs[r["key"]] = max(errs[r["key"]], r["err"])
    del stream_scene, seng
    print(f"phases 16-17: {time.perf_counter() - t0:.1f} s")
    with prebuilt_dragon(scenes, sh, cam):
        stream_launches = render_stream(sh, scene, cam, card)
    del scene
    print("dragon_scene(nu=96, nv=64, env_h=64), engine stream:")
    # 16 bounces (64 until iwalk ran at the two-level dragon's full render
    # shapes) and 1 spp (4 until phases 22-23 came, 2 until phase 25 came):
    # its CPU half, the stream's plain version, is the smoke's longest step
    cross_backend(lambda: scenes.dragon_scene(nu=96, nv=64, env_h=64), 32, 32, 1, engine="stream",
                  max_bounces=16)
    probe_t = phase_probes(card, others)
    t0 = time.perf_counter()
    phase_light_bvh(dev, card)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    two_errs, sh2, scene2, veng, ieng = phase_two_level_dragon(iwalk, walk, walk_eng, sh, cam, dev,
                                                               card)
    errs.update(two_errs)
    del walk_eng, sh
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    two_t, sh_m, cam_m = phase_two_level_shapes(iwalk, walk, scenes, scene2, veng, ieng, cam, dev,
                                                card, others)
    for rs in two_t.values():
        for r in rs.values():
            errs[r["key"]] = max(errs[r["key"]], r["err"])
    del veng, ieng
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")
    vwalk_launches, _ = render_cli(
        "dragon_scene", DRAGON_SPP, card, ("vwalk_closest", "vwalk_any", "closest"), two_level=True,
        absent=("walk_closest", "walk_any", "iwalk_closest", "iwalk_any"))
    print(f"dragon_scene --two-level bounce steps: {vwalk_launches['vwalk_any']} (one any-hit per step)")
    many_launches, _ = render_cli(
        "many_instance_scene", MANY_SPP, card, ("vwalk_closest", "vwalk_any", "closest"),
        width=MANY_W, height=MANY_H, two_level=True,
        absent=("walk_closest", "walk_any", "iwalk_closest", "iwalk_any"))
    print(f"many_instance_scene --two-level bounce steps: {many_launches['vwalk_any']}")
    iwalk_launches = render_iwalk_cli(card)
    t0 = time.perf_counter()
    film_t["many"] = phase_film("many_instance_scene --two-level", sh_m, sh_m.device(DEVICE), cam_m,
                                MANY_W, MANY_H, MANY_SPP, MANY_FILM_TILES, card)
    print(f"phase 22 (many_instance_scene): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_gather(sh_m, cam_m, dev, card)
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")
    del sh_m, cam_m
    render_iwalk_dragon(sh2, scene2, cam, card)
    del scene2, sh2
    print("many_instance_scene(grid=3, subdivisions=1) two-level:")
    small = lambda: scenes.many_instance_scene(grid=3, subdivisions=1, two_level=True)  # noqa: E731
    means = {e: cross_backend(small, 32, 32, 4, engine=e) for e in ("vwalk", "iwalk")}
    baked = cross_backend(lambda: scenes.many_instance_scene(grid=3, subdivisions=1), 32, 32, 4)
    rel = abs(means["vwalk"] - baked) / baked
    print(f"  two-level (vwalk) vs baked on the card: mean rel diff {rel:.5f} (limit {MEAN_TOL})")
    check(rel <= MEAN_TOL, rel)
    phase_interactive(card)
    phase_sharded(card)
    t0 = time.perf_counter()
    phase_inputs(dc, walk, dev, card)
    print(f"phase 26: {time.perf_counter() - t0:.1f} s")

    rows = {
        "closest": dense_t["camera"], "any": dense_t["shadow"],
        "walk_closest": walk_t["bounce"], "walk_any": walk_t["shadow"],
        "vwalk_closest": two_t["dragon"]["bounce"], "vwalk_any": two_t["dragon"]["shadow"],
        "iwalk_closest": two_t["many"]["bounce"], "iwalk_any": two_t["many"]["shadow"],
        "stream_closest": stream_t["bounce"], "stream_any": stream_t["shadow"],
        **probe_t,
    }
    launches = {**{k: dense_launches[k] for k in ("closest", "any")},
                **{k: walk_launches[k] for k in ("walk_closest", "walk_any")},
                **{k: vwalk_launches[k] for k in ("vwalk_closest", "vwalk_any")},
                **{k: iwalk_launches[k] for k in ("iwalk_closest", "iwalk_any")},
                **{k: stream_launches[k] for k in ("stream_closest", "stream_any")},
                **{k: r["launches"] for k, r in probe_t.items()}}
    errs.update({k: 0.0 for k in probe_t})  # the probes are held to exact equality
    kernels = []
    for key, r in rows.items():
        src = {"walk": WALK_SRC, "vwalk": IWALK_SRC, "iwalk": IWALK_SRC, "stream": STREAM_SRC,
               "row": PROBE_SRC, "tile": PROBE_SRC}.get(key.split("_")[0], DENSE_SRC)
        kernels.append({
            "name": key if "_" in key else f"dense_{key}", "route": "cuda",
            "source": src, "replaces": REPLACES[key],
            "launches": launches[key], "max_abs_err": errs[key], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "rays": r["rays"],
            **({"tested_pairs": r["tested_pairs"], "needed_pairs": r["needed_pairs"]}
               if "tested_pairs" in r else {}),
            **({"needed_pairs_512": r["needed_pairs_512"]} if "needed_pairs_512" in r else {}),
            **{k: r[k] for k in ("issue_ms", "library_issue_ms", "host_issue_ms",
                                 "library_host_issue_ms", "floor_ms") if k in r},
            "plain_rays": r.get("plain_rays", PLAIN_RAYS if src != DENSE_SRC else r["rays"]),
        })
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
