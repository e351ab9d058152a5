"""The whole slice: the port's ``render_sample`` against the JAX package's on
identical scene tables, with the JAX side running the Pallas dense kernels
in interpret mode inside its bounce loop (its scene dict gets ``dense_pl``
as ``Scene.device()`` builds it on a TPU, ``walk`` for a world soup above
16,384 triangles, or a two-level engine, vwalk or iwalk, in
``twolevel["iwalk"]``). 16x16, 2 spp, 8 bounces.

Pixel-exact equality is not expected: XLA fuses products and sums into FMAs
and its transcendentals differ from torch's in the last bit, which moves
hit points by ulps and, on a few lanes, flips a knife-edge hit or a Russian
roulette draw for the rest of that path. So: at least 95% of pixels within
rtol 1e-3, atol 1e-4; image means within 1%; ray counts within 1%;
first-hit model ids equal on at least 99% of lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu import native
from path_tracer_tpu import scenes as jscenes
from path_tracer_tpu.integrator.wavefront import render_sample as jrender
from path_tracer_tpu.scene.scene import Scene as JScene
from path_tracer_tpu.trace import iwalk as jiwalk
from path_tracer_tpu.trace import walk as jwalk
from path_tracer_tpu.trace.dense_pallas import pack_dense_pl, pack_dense_pl_aux, pack_dense_pl_cab
from path_tracer_tpu_torch import scenes as tscenes
from path_tracer_tpu_torch.camera import ray_directions
from path_tracer_tpu_torch.integrator import wavefront as tw
from path_tracer_tpu_torch.scene.scene import from_jax_scene
from path_tracer_tpu_torch.trace import iwalk as tiwalk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W = H = 16
SPP, BOUNCES = 2, 8


def _jax_scene_with_dense_pl(sh):
    """The JAX device dict with the TPU's dense engine swapped in."""
    jd = sh.device()
    jd["bvh"].pop("stream", None)
    jd["tri"].pop("dense", None)
    t = sh.num_world_tris
    jd["tri"]["dense_pl"] = {
        "w": jnp.asarray(pack_dense_pl(sh.tri)),
        "aux": jnp.asarray(pack_dense_pl_aux(sh.tri, sh.tri["normals"].reshape(t, 9), sh.tri["model"])),
        "cab": jnp.asarray(pack_dense_pl_cab(sh.tri["positions"])),
    }
    return jd


def _jax_scene_with_walk(sh):
    """The JAX device dict with its walk engine, as ``Scene.device()``
    packs it on a TPU (``tests/test_walk_integration.py``)."""
    jd = sh.device()
    t = sh.num_world_tris
    jd["tri"]["walk"] = {
        k: jnp.asarray(v)
        for k, v in jwalk.pack_walk(sh.tri, sh.tri["normals"].reshape(t, 9), sh.tri["model"],
                                    sh.tri["positions"]).items()
    }
    return jd


def _jax_two_level(packer):
    """The JAX scene dict for ``packer``: the two-level device dict with its
    engine set by hand, as ``tests/test_twolevel.py:141-143`` does (its
    ``Scene.device()`` packs the engine only on a TPU)."""

    def build(sh):
        two = JScene(sh.models, env=sh.env, two_level=True)
        jd = two.device()
        assert not jd["tri"]
        jd["twolevel"]["iwalk"] = {k: jnp.asarray(v) for k, v in packer(two.models).items()}
        return jd

    return build


# dragon_scene cut to 24,588 world tris: above the dense engine's 16,384
DRAGON_KW = {"nu": 96, "nv": 64, "env_h": 32}
# many_instance_scene cut to 9 instances of an 80-tri icosphere
MANY_KW = {"grid": 3, "subdivisions": 1}


def _render_both(name, engine=_jax_scene_with_dense_pl, **kw):
    sh, cam = getattr(jscenes, name)(**kw)
    jd = engine(sh)
    ndc, org = cam.view_proj_inverse(), cam.origin
    args = dict(max_bounces=BOUNCES, spp=SPP, mtypes=sh.active_mtypes, any_volumes=sh.has_volumes)
    j = jrender(jd, jnp.asarray(ndc), jnp.asarray(org), 0, W, H, **args)
    td = from_jax_scene(jax.tree_util.tree_map(np.asarray, jd), "cpu")
    t = tw.render_sample(td, torch.from_numpy(ndc), torch.from_numpy(org), 0, W, H, **args)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _assert_slice_agrees(j, t):
    jr, tr = j[0], t[0]
    assert np.isfinite(tr).all() and tr.mean() > 0
    close = np.isclose(tr, jr, rtol=1e-3, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.95, close.mean()
    assert abs(tr.mean() - jr.mean()) <= 0.01 * jr.mean()
    np.testing.assert_allclose(t[3].sum(axis=0), j[3].sum(axis=0), rtol=0.01)
    assert (t[2] == j[2].astype(np.int64)).mean() >= 0.99


@pytest.mark.parametrize("name,kw", [("mesh_scene", {"subdivisions": 2}), ("cornell_specular", {})])
def test_render_sample_matches_jax(name, kw):
    _assert_slice_agrees(*_render_both(name, **kw))


def test_render_sample_volume_matches_jax():
    """cornell_volume: the nested-media stack, free flight, HG scattering and
    Beer-Lambert absorption inside the loop."""
    _assert_slice_agrees(*_render_both("cornell_volume"))


def test_render_sample_walk_matches_jax():
    """dragon_scene's world queries through the walk engine on both sides:
    GGX glass with an absorbing, scattering medium under an equirect sky.
    The JAX tables come from its NumPy chunk partition, the port's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        j, t = _render_both("dragon_scene", engine=_jax_scene_with_walk, **DRAGON_KW)
    _assert_slice_agrees(j, t)


def test_from_jax_scene_walk_tables():
    """A >16K-triangle scene builds walk tables instead of raising, and
    ``from_jax_scene`` of the JAX dict gives the same tensors, bit for bit,
    as the port's own ``Scene.device``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        jsh, _ = jscenes.dragon_scene(**DRAGON_KW)
    tsh, _ = tscenes.dragon_scene(**DRAGON_KW)
    assert tsh.num_world_tris == jsh.num_world_tris == 24588
    port = tsh.device("cpu")
    assert "walk" in port["tri"] and "dense" not in port["tri"]
    assert "dense" in port["light"]
    ported = from_jax_scene(jax.tree_util.tree_map(np.asarray, jsh.device()), "cpu")
    assert ported["tri"]["walk"].keys() == port["tri"]["walk"].keys()
    for k, v in port["tri"]["walk"].items():
        assert torch.equal(ported["tri"]["walk"][k], v), k
    for k in ("normals_flat", "model_rows"):
        assert torch.equal(ported["tri"][k], port["tri"][k]), k
    torch.testing.assert_close(ported["env"], port["env"], rtol=0, atol=0)


@pytest.mark.parametrize("packer", [jiwalk.pack_vwalk, jiwalk.pack_iwalk], ids=["vwalk", "iwalk"])
def test_render_sample_two_level_matches_jax(packer):
    """many_instance_scene two-level: every world query through a two-level
    engine on both sides (the shade dict's world normal, rotated by the
    instance's forward rotation, and its model id)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        j, t = _render_both("many_instance_scene", engine=_jax_two_level(packer), **MANY_KW)
    _assert_slice_agrees(j, t)


def test_from_jax_scene_two_level_tables():
    """``from_jax_scene`` of a JAX two-level dict gives the port's own
    two-level ``Scene.device`` tables bit for bit (both engines), an empty
    ``tri``, and the same light tables; a multi-part engine raises."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        jsh, _ = jscenes.many_instance_scene(**MANY_KW)
        jd = _jax_two_level(jiwalk.pack_vwalk)(jsh)
        parts = jiwalk.pack_vwalk(jsh.models, split_vch=4)
    tsh, _ = tscenes.many_instance_scene(**MANY_KW, two_level=True)
    assert tsh.num_world_tris == jsh.num_world_tris == 732  # 12 shell + 9 x 80
    ported = from_jax_scene(jax.tree_util.tree_map(np.asarray, jd), "cpu")
    for engine, jeng in (("vwalk", None), ("iwalk", jiwalk.pack_iwalk(jsh.models))):
        port = tsh.device("cpu", engine=engine)
        assert port["tri"] == {} and "dense" in port["light"]
        if jeng is not None:
            jd["twolevel"]["iwalk"] = jeng
            ported = from_jax_scene(jax.tree_util.tree_map(np.asarray, jd), "cpu")
        assert ported["tri"] == {}
        got, want = ported["twolevel"]["iwalk"], port["twolevel"]["iwalk"]
        assert tiwalk.engine_name(want) == engine and got.keys() == want.keys()
        for k, v in want.items():
            assert (got[k] == v) if k == "gates" else torch.equal(got[k], v), k
        for k, v in port["light"]["dense"].items():
            assert torch.equal(ported["light"]["dense"][k], v), k
    jd["twolevel"]["iwalk"] = parts
    with pytest.raises(NotImplementedError):
        from_jax_scene(jax.tree_util.tree_map(np.asarray, jd), "cpu")


def test_shade_epilogue_matches_gathered_normals():
    """The dense kernel's fused normal/model fetch equals the gathered
    (baked) path of ``_hit_normal``/``_hit_material_model``."""
    sh, cam = tscenes.mesh_scene(subdivisions=2)
    scene = sh.device("cpu")
    n = W * H
    lane = torch.arange(n)
    u = ((lane % W).float() + 0.5) / W
    v = ((lane // W).float() + 0.5) / H
    ndc, org = torch.from_numpy(cam.view_proj_inverse()), torch.from_numpy(cam.origin)
    d = ray_directions(ndc, org, u, v)
    o = org.expand(n, 3)
    ti, t, hu, hv, inst, shade = tw._world_closest(scene, o, d, torch.full((n,), float("inf")))
    hit = ti >= 0
    assert hit.float().mean() > 0.5 and inst is None
    ns, fs = tw._hit_normal(scene, ti, hu, hv, d, inst, shade)
    nb, fb = tw._hit_normal(scene, ti, hu, hv, d, inst, None)
    torch.testing.assert_close(ns[hit], nb[hit], rtol=1e-6, atol=1e-6)
    assert torch.equal(fs[hit], fb[hit])
    ms, _ = tw._hit_material_model(scene, ti, inst, shade)
    mb, _ = tw._hit_material_model(scene, ti, inst, None)
    assert torch.equal(ms[hit], mb[hit])


def test_render_resumes_bit_exactly():
    """``render`` in one go equals the same samples resumed one at a time:
    each lane's samples are summed in the same order (pinned lanes)."""
    sh, cam = tscenes.cornell_diffuse()
    full = tw.render(sh, cam, 8, 8, 3, "cpu", max_bounces=BOUNCES)
    part = None
    for s in range(3):
        part = tw.render(sh, cam, 8, 8, 1, "cpu", max_bounces=BOUNCES, start_sample=s, film=part)
    assert (full[..., 3] == 3).all()
    assert full[..., :3].mean() > 0
    assert torch.equal(part, full)
