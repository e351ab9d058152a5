"""The port's pooled work queue (``trace_lanes(pool=True)``) and tiled
``render_film`` (``path_tracer_tpu_torch/integrator/wavefront.py``) against
its pinned lanes and against the JAX package's ``render_film``.

Every RNG draw is keyed on (pixel, sample, bounce, site), so the pooled
queue traces the same samples as pinned lanes and only sums a pixel's
samples in another order: at 1 spp no pixel has a second sample, so the two
are bit-equal; at 4 spp the films agree within reassociation (rtol 1e-5)
and the ray totals are equal. Pinned tiles trace each lane as the whole
film does, so a tiled film is bit-equal to ``render_sample``. The parity
case against the JAX package uses ``tests/test_torch_render.py``'s scene
helper and slice tolerances (16x16, 2 spp, 8 bounces, two tiles of 128
lanes, so one JAX compile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import BOUNCES, H, SPP, W, _jax_scene_with_dense_pl

from path_tracer_tpu import scenes as jscenes
from path_tracer_tpu.integrator.wavefront import render_film as jrender_film
from path_tracer_tpu_torch import scenes as tscenes
from path_tracer_tpu_torch.integrator import wavefront as tw
from path_tracer_tpu_torch.scene.scene import from_jax_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = W * H


@pytest.fixture(scope="module")
def mesh():
    """mesh_scene (dense engine) on the CPU: its tensors, camera and the
    render arguments."""
    sh, cam = tscenes.mesh_scene(subdivisions=2)
    scene = sh.device("cpu")
    ndc, org = torch.from_numpy(cam.view_proj_inverse()), torch.from_numpy(cam.origin)
    kw = dict(max_bounces=BOUNCES, mtypes=sh.active_mtypes, any_volumes=sh.has_volumes)
    return sh, cam, scene, ndc, org, kw


def _lanes(mesh, spp, pool):
    _, _, scene, ndc, org, kw = mesh
    return tw.trace_lanes(scene, ndc, org, 0, torch.arange(N), W, H, spp=spp, pool=pool, **kw)


def test_pooled_one_spp_is_pinned(mesh):
    """At 1 spp every lane keeps its pixel: radiance and ray counts bit-equal;
    the pooled position and first-id buffers are zero. The queue needs
    contiguous lane ids."""
    pin, pool = _lanes(mesh, 1, False), _lanes(mesh, 1, True)
    assert pin[0].mean() > 0
    assert torch.equal(pool[0], pin[0]) and torch.equal(pool[3], pin[3])
    assert not pool[1].any() and not pool[2].any()
    _, _, scene, ndc, org, kw = mesh
    with pytest.raises(ValueError, match="contiguous"):
        tw.trace_lanes(scene, ndc, org, 0, torch.tensor([0, 2, 3]), W, H, pool=True, **kw)


def test_pooled_four_spp_within_reassociation(mesh):
    """At 4 spp lanes move between pixels: the film within rtol 1e-5 of
    pinned, the ray totals equal, and fewer bounce steps (the wave stays
    full until the queue drains). Through ``render`` the films' sample
    counts (alpha) are equal too."""
    tw.STEPS.update(bounce=0, calls=0)
    pin = _lanes(mesh, 4, False)
    pin_steps = tw.STEPS["bounce"]
    pool = _lanes(mesh, 4, True)
    assert tw.STEPS["calls"] == 2
    assert tw.STEPS["bounce"] - pin_steps < pin_steps
    torch.testing.assert_close(pool[0], pin[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(pool[3].sum(0), pin[3].sum(0))
    sh, cam = mesh[:2]
    films = [tw.render(sh, cam, 8, 8, 4, "cpu", max_bounces=BOUNCES, pool=p) for p in (False, True)]
    assert torch.equal(films[0][..., 3], films[1][..., 3])
    torch.testing.assert_close(films[1], films[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tile", [96, 128])
def test_pinned_tiles_are_render_sample(mesh, tile):
    """Pinned ``render_film`` in tiles of 96 lanes (two full tiles and a
    64-lane remainder) or 128 (two full tiles) is bit-equal to
    ``render_sample`` over the whole film, ray totals included."""
    _, _, scene, ndc, org, kw = mesh
    rad, _, _, rays = tw.render_sample(scene, ndc, org, 3, W, H, spp=2, **kw)
    tw.STEPS.update(bounce=0, calls=0)
    frad, frays = tw.render_film(scene, ndc, org, 3, W, H, 2, tile_lanes=tile, pool=False, **kw)
    assert tw.STEPS["calls"] == -(-N // tile)
    assert torch.equal(frad, rad)
    assert torch.equal(frays, rays.sum(0, dtype=torch.float64))


def test_spp_batch_identity(mesh, monkeypatch):
    """``PT_SPP_BATCH`` (as JAX ``tests/test_multipass.py:230``): pinned
    batches of 1 keep each lane's add order, so bit-equal to one batch;
    batches of 3 (8 = 3 + 3 + 2) reassociate each sum; pooled batches of 1
    and 3 trace the same samples, so within reassociation of the unbatched
    pooled film, with equal ray totals. A missing or doubled sample would
    move every pixel by ~1/8."""
    _, _, scene, ndc, org, kw = mesh

    def go(batch, pool):
        monkeypatch.setenv("PT_SPP_BATCH", str(batch))
        return tw.render_film(scene, ndc, org, 0, W, H, 8, pool=pool, **kw)

    pin, pin_rays = go(0, False)
    assert torch.equal(go(1, False)[0], pin)
    torch.testing.assert_close(go(3, False)[0], pin, rtol=1e-5, atol=1e-4)
    pool, pool_rays = go(0, True)
    torch.testing.assert_close(pool, pin, rtol=1e-5, atol=1e-4)
    for batch in (1, 3):
        rad, rays = go(batch, True)
        torch.testing.assert_close(rad, pool, rtol=1e-5, atol=1e-4)
        assert torch.equal(rays, pool_rays) and torch.equal(rays, pin_rays)


def test_pooled_render_film_matches_jax():
    """The port's pooled ``render_film`` against the JAX package's on
    mesh_scene's tables, the JAX side running the Pallas dense kernels in
    interpret mode: two tiles of 128 lanes, pooled, at
    ``tests/test_torch_render.py``'s slice tolerances (95% of pixels within
    rtol 1e-3, atol 1e-4; means and ray totals within 1%)."""
    sh, cam = jscenes.mesh_scene(subdivisions=2)
    jd = _jax_scene_with_dense_pl(sh)
    ndc, org = cam.view_proj_inverse(), cam.origin
    args = dict(max_bounces=BOUNCES, mtypes=sh.active_mtypes, any_volumes=sh.has_volumes,
                tile_lanes=N // 2, pool=True)
    jr, jrays = (np.asarray(x) for x in jrender_film(jd, jnp.asarray(ndc), jnp.asarray(org), 0,
                                                      W, H, SPP, **args))
    td = from_jax_scene(jax.tree_util.tree_map(np.asarray, jd), "cpu")
    tr, trays = (x.numpy() for x in tw.render_film(td, torch.from_numpy(ndc), torch.from_numpy(org),
                                                    0, W, H, SPP, **args))
    assert np.isfinite(tr).all() and tr.mean() > 0
    assert np.isclose(tr, jr, rtol=1e-3, atol=1e-4).all(axis=1).mean() >= 0.95
    assert abs(tr.mean() - jr.mean()) <= 0.01 * jr.mean()
    np.testing.assert_allclose(trays, jrays, rtol=0.01)
