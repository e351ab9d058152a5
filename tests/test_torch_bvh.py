"""The port's stack BVH engine (``path_tracer_tpu_torch/trace/bvh_stack.py``)
against the JAX package's stack traversal (``path_tracer_tpu/trace/
traversal.py``, plain XLA), and the routes into it: light tables above
16,384 triangles and world soups above the streamed engine's 2,000,000; and
``PT_VWALK=0``, which sends a two-level scene through iwalk.

Both packages build their trees with the NumPy SAH builder
(``native.available`` patched to False), so the flat tables are compared
bit for bit. Both sides evaluate the same expressions in the same order;
XLA may fuse a product and a sum into a multiply-add, so a ray through a
shared triangle edge may resolve to the other triangle: winners are held
equal on at least 99.9% of rays and t at rtol 2e-4 where they agree. A
render of the 20,482-light-triangle scene is held as the other render
parity tests hold theirs: 95% of pixels within rtol 1e-3, image means
within 1%.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu import native
from path_tracer_tpu import scenes as jscenes
from path_tracer_tpu.integrator.wavefront import render_sample as jrender
from path_tracer_tpu.scene import bvh as jbvh
from path_tracer_tpu.scene import materials as jmat
from path_tracer_tpu.scene import procedural as jproc
from path_tracer_tpu.scene import triangle as jtri
from path_tracer_tpu.scene.model import Model as JModel
from path_tracer_tpu.scene.scene import Scene as JScene
from path_tracer_tpu.trace import traversal as jtrav
from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch import scenes as tscenes
from path_tracer_tpu_torch.integrator import wavefront as tw
from path_tracer_tpu_torch.scene import bvh as tbvh
from path_tracer_tpu_torch.scene import materials as tmat
from path_tracer_tpu_torch.scene import procedural as tproc
from path_tracer_tpu_torch.scene import scene as tscene
from path_tracer_tpu_torch.scene import triangle as ttri
from path_tracer_tpu_torch.scene.model import Model as TModel
from path_tracer_tpu_torch.trace import bvh_stack, dense_stream
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 2e-4
AGREE = 0.999


@pytest.fixture(autouse=True)
def _numpy_builder(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.fixture(scope="module")
def soup():
    """A 5,120-triangle icosphere inside a 12-triangle box, both packages'
    flat BVHs and plane tables, and 2,048 rays (half from inside the box in
    random directions, half from outside toward the sphere)."""
    jp, _ = jproc.icosphere((10.0, 20.0, -5.0), 40.0, 4)
    bp, _ = jproc.box((0.0, 0.0, 0.0), (100.0, 100.0, 100.0))
    pos = np.concatenate([jp, bp]).astype(np.float32)
    lo, hi = jtri.aabbs(pos)
    jflat, jperm, _ = jbvh.build_bvh(lo, hi)
    tflat, tperm, depth = tbvh.build_bvh(*ttri.aabbs(pos))
    assert np.array_equal(jperm, tperm) and depth <= bvh_stack.STACK_DEPTH
    jt = jtri.precompute(pos[jperm])
    tt = ttri.precompute(pos[tperm])
    rng = np.random.default_rng(7)
    n = 2048
    o = np.concatenate([rng.uniform(-90, 90, (n // 2, 3)),
                        rng.normal(size=(n // 2, 3)) * 150.0]).astype(np.float32)
    target = rng.uniform(-30, 30, (n, 3)).astype(np.float32) + np.float32([10, 20, -5])
    d = np.where(np.arange(n)[:, None] < n // 2, rng.normal(size=(n, 3)), target - o)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:16, 1:] = 0.0  # axis-parallel
    d[:16, 0] = 1.0
    return jflat, tflat, depth, jt, tt, o, d


def test_flat_tables_match_jax(soup):
    jflat, tflat, depth, jt, tt, _, _ = soup
    assert set(jflat) == set(tflat)
    for k in jflat:
        assert np.array_equal(jflat[k], tflat[k]), k
    tab = bvh_stack.pack(tflat, depth, tt)
    assert np.array_equal(tab["nodes"], np.asarray(jtrav.pack_bvh(jflat)))
    assert np.array_equal(tab["tris"], np.asarray(jtrav.pack_tris(jt)))
    with pytest.raises(ValueError, match="STACK_DEPTH"):
        bvh_stack.pack(tflat, bvh_stack.STACK_DEPTH + 1, tt)


def test_queries_match_jax(soup):
    """Closest hit and any hit on the same tables and rays, with an infinite,
    a finite and a zero limit."""
    jflat, tflat, depth, jt, tt, o, d = soup
    n = o.shape[0]
    tl = np.full(n, np.inf, np.float32)
    tl[: n // 8] = 0.0
    tl[n // 8 : n // 4] = 60.0
    jn, jtr = jtrav.pack_bvh(jflat), jtrav.pack_tris(jt)
    ji, jtt, ju, jv = (np.asarray(x) for x in jtrav._closest_hit_impl(jn, jtr, o, d, tl))
    tab = {k: torch.from_numpy(v) for k, v in bvh_stack.pack(tflat, depth, tt).items()}
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tl))
    ti, tt_, tu, tv = (x.numpy() for x in bvh_stack.closest_hit(tab, *args))
    same = ti == ji
    assert same.mean() >= AGREE and 0.3 < (ji >= 0).mean() < 1.0
    assert (ti[: n // 8] == -1).all() and np.array_equal(tt_[~(ti >= 0)], tl[~(ti >= 0)])
    for a, b in ((tt_, jtt), (tu, ju), (tv, jv)):
        np.testing.assert_allclose(a[same], b[same], rtol=RTOL, atol=1e-5)
    # shadow limits around each closest t
    scale = np.random.default_rng(8).uniform(0.5, 1.5, n).astype(np.float32)
    tl_any = np.where(ji >= 0, jtt * scale, tl).astype(np.float32)
    ja = np.asarray(jtrav._any_hit_impl(jn, jtr, o, d, tl_any))
    ta = bvh_stack.any_hit(tab, args[0], args[1], torch.from_numpy(tl_any)).numpy()
    assert (ta == ja).mean() >= AGREE and 0.1 < ja.mean() < 0.9


def _glow_models(proc, mat, model_cls, shell):
    """The Cornell shell plus an emissive icosphere(subdivisions=5): 20,482
    light triangles (the sphere's 20,480 and the ceiling light's 2)."""
    sp, sn = proc.icosphere((0.0, 250.0, 0.0), 90.0, 5)
    return shell() + [model_cls(mat.Emissive((4.0, 3.0, 2.0)), positions=sp, normals=sn)]


def test_large_light_table_renders_like_jax():
    """The 20,482-light-triangle scene: the port's lights go through the stack
    BVH (the old port raised here) and render like the JAX package's, whose
    lights BVH takes them the same way."""
    js = JScene(_glow_models(jproc, jmat, JModel, jscenes._cornell_shell))
    ts = tscene.Scene(_glow_models(tproc, tmat, TModel, tscenes._cornell_shell))
    assert ts.light["pdf"].shape[0] == 20482
    td = ts.device("cpu")
    assert "bvh" in td["light"] and "dense" not in td["light"]
    jd = js.device()
    assert np.array_equal(td["light"]["bvh"]["nodes"].numpy(), np.asarray(jd["lights_bvh"]["packed"]))
    assert np.array_equal(td["light"]["cdf"].numpy(), np.asarray(jd["light"]["cdf"]))
    cam = jscenes.cornell_camera()
    ndc, org = cam.view_proj_inverse(), cam.origin
    args = dict(max_bounces=4, spp=1, mtypes=ts.active_mtypes, any_volumes=ts.has_volumes)
    j = [np.asarray(x) for x in jrender(jd, jnp.asarray(ndc), jnp.asarray(org), 0, 8, 8, **args)]
    t = [x.numpy() for x in tw.render_sample(td, torch.from_numpy(ndc), torch.from_numpy(org),
                                             0, 8, 8, **args)]
    jr, tr = j[0], t[0]
    assert np.isfinite(tr).all() and tr.mean() > 0
    assert np.isclose(tr, jr, rtol=1e-3, atol=1e-4).all(axis=1).mean() >= 0.95
    assert abs(tr.mean() - jr.mean()) <= 0.01 * jr.mean()


def test_world_engine_above_the_stream():
    assert tscene.world_engine(dense_stream.DENSE_STREAM_MAX_TRIS) == "stream"
    assert tscene.world_engine(dense_stream.DENSE_STREAM_MAX_TRIS + 1) == "bvh"
    assert tscene.world_engine(dense_stream.DENSE_STREAM_MAX_TRIS + 1, "stream") == "bvh"


def test_cli_world_soup_through_bvh(monkeypatch, tmp_path, capsys):
    """With the streamed engine's limit patched below cornell_diffuse's 36
    triangles, the CLI renders the world through the stack BVH, like the
    dense engine's render of the same samples."""
    kw = ["--scene", "cornell_diffuse", "--width", "8", "--height", "8", "--spp", "1",
          "--max-bounces", "3", "--device", "cpu"]
    dense = cli.main(kw + ["--out", str(tmp_path / "d.png")])
    monkeypatch.setattr(dense_stream, "DENSE_STREAM_MAX_TRIS", 30)
    n0 = dict(LAUNCHES)
    res = cli.main(kw + ["--out", str(tmp_path / "b.png")])
    assert res["engine"] == "bvh" and "world engine: bvh" in capsys.readouterr().out
    assert dense["engine"] == "dense" and LAUNCHES == n0
    a, b = res["film"][..., :3], dense["film"][..., :3]
    assert torch.isfinite(a).all() and a.mean() > 0
    assert torch.isclose(a, b, rtol=1e-3, atol=1e-4).all(dim=-1).float().mean() >= 0.95


@pytest.mark.parametrize("pt_vwalk,engine", [("0", "iwalk"), ("1", "vwalk")])
def test_cli_pt_vwalk(monkeypatch, tmp_path, capsys, pt_vwalk, engine):
    """``PT_VWALK=0`` sends a two-level scene through iwalk, as in the JAX
    package (``twolevel_scene.py:137-141``); unset or 1, vwalk."""
    monkeypatch.setattr(tscenes, "many_instance_scene",
                        functools.partial(tscenes.many_instance_scene, grid=2, subdivisions=1))
    monkeypatch.setenv("PT_VWALK", pt_vwalk)
    assert tscene.env_engine(100, two_level=True) == (None if pt_vwalk == "1" else "iwalk")
    assert tscene.env_engine(100_000, two_level=False) is None
    res = cli.main(["--scene", "many_instance_scene", "--two-level", "--width", "8", "--height", "8",
                    "--spp", "1", "--max-bounces", "2", "--out", str(tmp_path / "x.png"),
                    "--device", "cpu"])
    assert res["engine"] == engine and f"two-level engine: {engine}" in capsys.readouterr().out
    assert torch.isfinite(res["film"]).all() and res["film"][..., :3].mean() > 0
