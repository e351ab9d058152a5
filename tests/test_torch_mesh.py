"""The port's multi-card rendering (``path_tracer_tpu_torch/parallel``) on the
CPU: one 4-rank gloo group, spawned once for the module through a
``FileStore`` (``tests/torch_mesh_ranks.py`` runs every sharded case in it),
held against the port's single-process renders case by case as
``tests/test_multichip.py`` holds the JAX package's, and tile and spp
sharding against the JAX package's sharded functions.

Tolerances: the JAX package's own for sharded against single (rtol 1e-5,
atol 1e-6, ids exact; spp sums rtol 1e-6, atol 1e-6; defocus at least 99%
of lanes identical and means within 2%; the session's display rtol 1e-4,
atol 1e-5), and against the JAX package ``tests/test_torch_render.py``'s: at
least 95% of pixels within rtol 1e-3, atol 1e-4, means within 1%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_mesh_ranks as ranks
from path_tracer_tpu import scenes as jscenes
from path_tracer_tpu.parallel.mesh import make_mesh
from path_tracer_tpu.parallel.mesh import render_sample_sharded as jtile
from path_tracer_tpu.parallel.mesh import render_spp_sharded as jspp
from path_tracer_tpu_torch import cli, scenes
from path_tracer_tpu_torch.integrator import wavefront as wf
from path_tracer_tpu_torch.interactive.session import InteractiveRenderer
from path_tracer_tpu_torch.parallel.mesh import make_group, render_sharded, shard_lanes
from test_torch_render import _jax_scene_with_dense_pl
from torch_builders import numpy_builders  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

WORLD = 4
W, H = ranks.W, ranks.H


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every rank's results (``torch_mesh_ranks.run``), by rank."""
    tmp = tmp_path_factory.mktemp("mesh")
    mp.start_processes(ranks.run, args=(WORLD, str(tmp / "store"), str(tmp)), nprocs=WORLD,
                       start_method="spawn")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


def _single(sh, cam, scene, sample, bounces, **kw):
    ndc, org, args = ranks.cam_args(sh, cam)
    return wf.render_sample(scene, ndc, org, sample, W, H, max_bounces=bounces, **args, **kw)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def cornell():
    sh, cam = scenes.cornell_diffuse()
    return sh, cam, sh.device("cpu")


def test_tile_sharded_matches_single(group, cornell):
    rad, rays = group[0]["tile"]
    ref = _single(*cornell, 0, ranks.BOUNCES)
    _close(rad, ref[0])
    assert float(rays.sum()) == float(ref[3].sum())
    for r in group[1:]:  # every rank gathered the same film
        assert all(torch.equal(a, b) for a, b in zip(r["tile"], group[0]["tile"]))


def test_spp_sharded_matches_sequential(group, cornell):
    expect = torch.zeros((W * H, 4))
    for s in range(WORLD):
        expect[:, :3] += _single(*cornell, s, ranks.BOUNCES)[0]
        expect[:, 3] += 1.0
    for r in group:  # the all_reduce's sum is on every rank
        _close(r["spp"], expect, rtol=1e-6, atol=1e-6)


def test_group_of_two(group, cornell):
    """A group of ranks 1 and 3: its own slabs (rank within the group),
    its own gather; the other ranks take no part."""
    assert "group2" not in group[0] and "group2" not in group[2]
    ref = _single(*cornell, 3, ranks.SHORT)
    for r in ranks.GROUP2:
        _close(group[r]["group2"][0], ref[0])


def test_two_level_sharded(group):
    two, cam = ranks.procedural_two_level()
    _close(group[0]["two_level"][0], _single(two, cam, two.device("cpu"), 0, ranks.SHORT)[0])


@pytest.mark.parametrize("engine", ["iwalk", "vwalk"])
def test_two_level_engine_sharded(group, engine):
    """many_instance_scene two-level through each engine: sharding is pure
    work division, so sharded equals single with the same engine."""
    many, cam = scenes.many_instance_scene(grid=3, subdivisions=1, two_level=True)
    ref = _single(many, cam, many.device("cpu", engine), 0, ranks.SHORT)
    _close(group[0][engine][0], ref[0])


def test_defocus_sharded_matches_single(group, cornell):
    sh, cam, scene = cornell
    ref = _single(sh, cam, scene, 2, ranks.SHORT, aperture=80.0, focus=cam.focus_distance,
                  cam_basis=torch.from_numpy(cam.matrix[:, :3]))[0].numpy()
    got = group[0]["defocus"][0].numpy()
    same = (np.abs(got - ref).max(axis=-1) < 1e-5).mean()
    assert same >= 0.99, same
    assert abs(got.mean() - ref.mean()) < 0.02 * max(ref.mean(), 1e-6)


def test_render_sharded_matches_render(group, cornell):
    sh, cam, _ = cornell
    ref = wf.render(sh, cam, W, H, 2, "cpu", max_bounces=ranks.BOUNCES)
    for r in group:
        _close(r["progressive"], ref)


def test_frame_segmented_sharded(group, cornell):
    """The sharded frame under the forced small schedule (each rank
    compacts its own 256-lane slab) against the single-process frame;
    predicted sharded frames bit-equal to count-driven ones, and a plan
    sabotaged to 4-lane caps caught by the status check."""
    ref = _single(*cornell, 0, ranks.FRAME_BOUNCES)
    rad, pos, fid, rays = group[0]["frame"]
    _close(rad, ref[0])
    _close(pos, ref[1], rtol=1e-5, atol=1e-5)
    assert fid.dtype == torch.int64 and torch.equal(fid, ref[2])
    assert bool(torch.isfinite(rays).all())
    for r in group:
        assert r["predicted"] == {"same": [True] * 3, "plan": True, "overflows": 0}
        assert r["sabotaged"] == {"same": True, "overflows": 1}


def test_session_sharded_matches_single(group):
    """Three frames of a 4-rank session (a camera move before the third:
    the TAA path), then a resize on rank 0 alone and a fourth frame,
    against one process's session with the same input."""
    sh, cam = scenes.cornell_diffuse()
    r = InteractiveRenderer(sh, cam, W, H, max_bounces=ranks.BOUNCES, device="cpu")
    want = []
    for i in range(4):
        if i == 2:
            r.mouse(2e-4, 1e-4, 1.0 / 60.0)
            r.key("w", 6e-6)
        if i == 3:
            r.resize(W, H // 2)
        r.frame()
        if i >= 2:
            want.append((r.accumulation, r.ids, torch.from_numpy(r.display().copy())))
    assert want[1][0].shape == (H // 2, W, 4)
    for rank in group:  # accumulation, TAA and display run on every rank
        for (acc, ids, img), (acc_w, ids_w, img_w) in zip(rank["session"], want):
            _close(acc, acc_w)
            assert torch.equal(ids, ids_w)
            _close(img, img_w, rtol=1e-4, atol=1e-5)


def test_segmented_slab_matches_rows(cornell, monkeypatch):
    """``render_sample_segmented(lane=slab)`` in one process: the slab's
    rows of `render_sample`, bit for bit, under the forced small schedule;
    each slab keys its own plan; lanes that are not contiguous raise."""
    monkeypatch.setattr(wf, "_SEG_B0", 2)
    monkeypatch.setattr(wf, "_SEG_STEPS", 2)
    monkeypatch.setattr(wf, "_seg_caps", lambda n: [n // 2, n // 4])
    monkeypatch.setattr(wf, "_SEG_TAIL_AT", 0)
    monkeypatch.setattr(wf, "_SEG_TAIL_STEPS", 4)
    monkeypatch.setattr(wf, "_SEG_PREDICT", True)
    sh, cam, scene = cornell
    ndc, org, args = ranks.cam_args(sh, cam)
    ref = wf.render_sample(scene, ndc, org, 0, W, H, max_bounces=ranks.FRAME_BOUNCES, **args)
    keys = set()
    for r in (1, 2):
        sl = shard_lanes(W * H, r, WORLD)
        pred = wf.SegmentPredictor()
        got = wf.render_sample_segmented(scene, ndc, org, 0, W, H, max_bounces=ranks.FRAME_BOUNCES,
                                         predictor=pred, lane=torch.arange(sl.start, sl.stop),
                                         **args)
        for g, want in zip(got, ref):
            assert torch.equal(g, want[sl.start:sl.stop])
        keys.add(pred.key)
    assert len(keys) == 2
    with pytest.raises(ValueError, match="contiguous"):
        wf.render_sample_segmented(scene, ndc, org, 0, W, H, lane=torch.arange(0, W * H, 2),
                                   **args)


def test_shard_lanes():
    assert shard_lanes(W * H, 1, WORLD) == range(256, 512)
    with pytest.raises(ValueError, match="divisible"):
        shard_lanes(W * H + 2, 0, WORLD)


def test_cuda_without_a_card_raises(cornell):
    """The functions that pick the rank's card raise without one, before
    joining any group; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sh, cam, _ = cornell
    with pytest.raises(RuntimeError, match="cuda"):
        make_group()
    with pytest.raises(RuntimeError, match="cuda"):
        render_sharded(sh, cam, W, H, 1)
    assert not torch.distributed.is_initialized()


def test_cli_multichip_cpu(tmp_path):
    """``--multichip --device cpu``: a group of one gloo rank, the same film
    as the single-process CLI."""
    common = ["--scene", "cornell_diffuse", "--width", str(W), "--height", str(H), "--spp", "2",
              "--max-bounces", "4", "--device", "cpu"]
    one = cli.main([*common, "--out", str(tmp_path / "one.png")])
    many = cli.main([*common, "--out", str(tmp_path / "many.png"), "--multichip"])
    assert many["ranks"] == 1 and (tmp_path / "many.png").exists()
    _close(many["film"], one["film"])


def _slice_agrees(got, want):
    """tests/test_torch_render.py's cross-framework check."""
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    assert abs(got.mean() - want.mean()) <= 0.01 * want.mean()


@pytest.fixture(scope="module")
def jax_cornell():
    """The JAX dict with the Pallas dense engine (interpret mode), tables
    from the NumPy builder as the port's, and a mesh of 4 of the 8 virtual
    devices."""
    sh, cam = jscenes.cornell_diffuse()
    kw = dict(max_bounces=ranks.BOUNCES, mtypes=sh.active_mtypes, any_volumes=sh.has_volumes)
    return (_jax_scene_with_dense_pl(sh), jnp.asarray(cam.view_proj_inverse()),
            jnp.asarray(cam.origin), make_mesh(WORLD), kw)


def test_tile_matches_jax(group, jax_cornell):
    jd, ndc, org, mesh, kw = jax_cornell
    # jit: shard_map outside jit runs op by op on each virtual device
    rad, rays = jax.jit(lambda d, a, b: jtile(d, a, b, 0, W, H, mesh, **kw))(jd, ndc, org)
    _slice_agrees(group[0]["tile"][0].numpy(), np.asarray(rad))
    np.testing.assert_allclose(group[0]["tile"][1].sum(0).numpy(), np.asarray(rays).sum(0),
                               rtol=0.01)


def test_spp_matches_jax(group, jax_cornell):
    jd, ndc, org, mesh, kw = jax_cornell
    acc = jax.jit(lambda d, a, b: jspp(d, a, b, 0, W, H, mesh, **kw))(jd, ndc, org)
    got, want = group[0]["spp"].numpy(), np.asarray(acc)
    _slice_agrees(got[:, :3], want[:, :3])
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
