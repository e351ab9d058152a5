"""One rank of ``tests/test_torch_mesh.py``'s 4-rank gloo group: every
sharded case of the port's ``parallel/mesh.py`` and the sharded session,
run once in the spawned ranks; each rank saves what it computed to
``<out>/rank<r>.pt`` for the tests to hold against single-process renders.
Imports nothing of JAX (the ranks are fresh interpreters without the test
configuration).
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

from path_tracer_tpu_torch import native, scenes
from path_tracer_tpu_torch.integrator import wavefront as wf
from path_tracer_tpu_torch.interactive.session import InteractiveRenderer
from path_tracer_tpu_torch.parallel.mesh import (
    frame_segmented_sharded,
    gather_lanes,
    make_group,
    render_sample_sharded,
    render_sharded,
    render_spp_sharded,
)

W = H = 32
BOUNCES = 6  # the tile, spp, progressive and session cases
SHORT = 4  # the group of two, two-level and defocus cases (test_multichip.py)
FRAME_BOUNCES = 8  # the segmented frame (tests/sharded_frame_check.py)
GROUP2 = [1, 3]  # the group of two: ranks that are not neighbours


def cam_args(sh, cam):
    return (torch.from_numpy(cam.view_proj_inverse()), torch.tensor(cam.origin),
            dict(has_lights=True, mtypes=sh.active_mtypes, any_volumes=sh.has_volumes))


def procedural_two_level():
    """test_multichip.py's two-level scene: the Cornell light and walls and
    one instanced icosphere."""
    from path_tracer_tpu_torch.scene import procedural
    from path_tracer_tpu_torch.scene.materials import Emissive, Lambertian
    from path_tracer_tpu_torch.scene.model import Model, rigid_transform, rotation_y
    from path_tracer_tpu_torch.scene.scene import Scene

    light_p, light_n = procedural.cornell_light()
    walls_p, walls_n = procedural.cornell_walls()
    sph_p, sph_n = procedural.icosphere((0.0, 250.0, 0.0), 120.0, 1)
    models = [
        Model(Emissive((15.0,) * 3), positions=light_p, normals=light_n),
        Model(Lambertian((0.7,) * 3), positions=walls_p, normals=walls_n),
        Model(Lambertian((0.2, 0.4, 0.7)),
              matrices=[rigid_transform(rotation_y(0.5), (0.0, -80.0, 0.0))],
              positions=sph_p, normals=sph_n),
    ]
    return Scene(models, two_level=True), scenes.cornell_camera()


def small_schedule():
    """sharded_frame_check.py's forced schedule: several segments and
    shrink levels on each rank's 256-lane slab."""
    wf._SEG_B0, wf._SEG_STEPS = 2, 2
    wf._seg_caps = lambda n: [n // 2, n // 4]
    wf._SEG_TAIL_AT, wf._SEG_TAIL_STEPS = 0, 4
    wf._SEG_PREDICT = True


def tile(sh, cam, scene, sample, bounces, group=None, **kw):
    ndc, org, args = cam_args(sh, cam)
    rad, rays = render_sample_sharded(scene, ndc, org, sample, W, H, group,
                                      max_bounces=bounces, **args, **kw)
    return gather_lanes(rad, group), gather_lanes(rays, group)


def session_frames(sh, cam):
    """Three frames with a move before the third, then a resize on rank 0
    and a fourth frame; (accumulation, ids, display) after the third and
    the fourth."""
    r = InteractiveRenderer(sh, cam, W, H, max_bounces=BOUNCES, device="cpu",
                            group=dist.group.WORLD)
    lead = dist.get_rank() == 0
    out = []
    for i in range(4):
        if lead and i == 2:
            r.mouse(2e-4, 1e-4, 1.0 / 60.0)
            r.key("w", 6e-6)
        if lead and i == 3:
            r.resize(W, H // 2)
        r.frame()
        if i >= 2:
            img = torch.from_numpy(r.display().copy())
            out.append((r.accumulation.clone(), r.ids.clone(), img))
    return out


def run(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    native.available = lambda: False  # the test process's builder (tests/torch_builders.py)
    # a rank that stops answering fails the group in 2 minutes, not gloo's 30
    make_group("cpu", store=dist.FileStore(store, world), rank=rank, world_size=world,
               timeout=timedelta(seconds=120))
    res = {}
    try:
        sh, cam = scenes.cornell_diffuse()
        scene = sh.device("cpu")
        ndc, org, args = cam_args(sh, cam)
        res["tile"] = tile(sh, cam, scene, 0, BOUNCES)
        res["spp"] = render_spp_sharded(scene, ndc, org, 0, W, H, max_bounces=BOUNCES, **args)
        g2 = dist.new_group(GROUP2)
        if rank in GROUP2:
            res["group2"] = tile(sh, cam, scene, 3, SHORT, group=g2)
        res["defocus"] = tile(sh, cam, scene, 2, SHORT, aperture=80.0, focus=cam.focus_distance,
                              cam_basis=torch.from_numpy(cam.matrix[:, :3]))
        res["progressive"] = render_sharded(sh, cam, W, H, 2, max_bounces=BOUNCES, device="cpu")

        two, tcam = procedural_two_level()
        res["two_level"] = tile(two, tcam, two.device("cpu"), 0, SHORT)
        many, mcam = scenes.many_instance_scene(grid=3, subdivisions=1, two_level=True)
        for engine in ("iwalk", "vwalk"):
            res[engine] = tile(many, mcam, many.device("cpu", engine), 0, SHORT)

        res["session"] = session_frames(sh, scenes.cornell_diffuse()[1])  # moves its camera

        small_schedule()
        fkw = dict(max_bounces=FRAME_BOUNCES, **args)
        res["frame"] = frame_segmented_sharded(scene, ndc, org, 0, W, H, **fkw)
        pred = wf.SegmentPredictor()
        same = []
        for sid in (0, 1, 2):
            ref = frame_segmented_sharded(scene, ndc, org, sid, W, H, **fkw)
            got = frame_segmented_sharded(scene, ndc, org, sid, W, H, predictor=pred, **fkw)
            same.append(all(torch.equal(a, b) for a, b in zip(ref, got)))
        res["predicted"] = {"same": same, "plan": bool(pred.plan), "overflows": pred.overflows}
        # caps of 4 lanes are far below every rank's early boundary counts
        pred.plan = tuple((4, st) for _, st in pred.plan)
        ref = frame_segmented_sharded(scene, ndc, org, 3, W, H, **fkw)
        got = frame_segmented_sharded(scene, ndc, org, 3, W, H, predictor=pred, **fkw)
        res["sabotaged"] = {"same": all(torch.equal(a, b) for a, b in zip(ref, got)),
                            "overflows": pred.overflows}
    finally:
        dist.destroy_process_group()
    torch.save(res, f"{out}/rank{rank}.pt")
