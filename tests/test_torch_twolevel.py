"""The port's two-level gather engine (``path_tracer_tpu_torch/trace/
twolevel.py``, ``scene/tlas.py``, ``scene/twolevel_scene.py``) against the
JAX package's plain-XLA one (``path_tracer_tpu/trace/twolevel.py``), and the
routes into it: a two-level scene over iwalk's caps, ``engine="gather"``,
``PT_IWALK=0`` and the JAX package's gather dict through ``from_jax_scene``.

Both packages build their BLASes with the NumPy SAH builder
(``native.available`` patched to False), so the tables are compared bit for
bit. Both sides evaluate the same expressions in the same order, but XLA
may contract a product and a sum into one multiply-add where torch rounds
each: moving a ray to a leaf's entry t then differs by an ulp of the scene's
coordinates (6e-5 at the Cornell box's 555 units), so t is held to rtol
1e-6 plus atol 1e-4, and a different winner is allowed only at the same t.
The render is held at ``tests/test_torch_render.py``'s slice tolerances.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_render import MANY_KW, _assert_slice_agrees, _render_both

from path_tracer_tpu import native
from path_tracer_tpu import scenes as jscenes
from path_tracer_tpu.scene import tlas as jtlas
from path_tracer_tpu.scene.scene import Scene as JScene
from path_tracer_tpu.trace import twolevel as jtl
from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch import scenes as tscenes
from path_tracer_tpu_torch.scene import scene as tscene
from path_tracer_tpu_torch.scene import tlas as ttlas
from path_tracer_tpu_torch.scene import twolevel_scene as tts
from path_tracer_tpu_torch.scene.scene import from_jax_scene
from path_tracer_tpu_torch.trace import iwalk as tiwalk
from path_tracer_tpu_torch.trace import twolevel as ttl
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_RAYS = 1024


@pytest.fixture(autouse=True)
def _numpy_builder(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


def _jax_gather(sh):
    """The JAX two-level device dict: on the CPU its ``Scene.device()``
    packs no fast engine, so its world goes through the gather machine."""
    jd = JScene(sh.models, env=sh.env, two_level=True).device()
    assert "iwalk" not in jd["twolevel"]
    return jd


@pytest.fixture(scope="module")
def many():
    """many_instance_scene cut to 9 icospheres in the Cornell shell: both
    packages' gather tables and 1,024 seeded rays from inside the box (an
    eighth with a zero limit, a quarter with a finite one)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        jsh, _ = jscenes.many_instance_scene(**MANY_KW)
        jd = _jax_gather(jsh)
    tsh, _ = tscenes.many_instance_scene(**MANY_KW, two_level=True)
    tab = tts.gather_tables(tsh.models)
    rng = np.random.default_rng(11)
    o = rng.uniform(-270.0, 270.0, (N_RAYS, 3)).astype(np.float32)
    o[:, 1] += 277.5
    d = rng.normal(size=(N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tl = np.full(N_RAYS, np.inf, np.float32)
    tl[: N_RAYS // 8] = 0.0
    tl[N_RAYS // 8 : N_RAYS // 4] = 150.0
    return jsh, jd, tsh, tab, o, d, tl


def test_gather_tables_match_jax(many):
    """``build_tlas``, ``pack_instances`` and every gather table bit-equal
    to the JAX package's."""
    jsh, jd, tsh, tab, _, _, _ = many
    for k in ttl.TABLES:
        assert np.array_equal(tab[k], np.asarray(jd["twolevel"][k])), k
    rng = np.random.default_rng(5)
    lo = rng.uniform(-50, 50, (23, 3)).astype(np.float32)
    hi = lo + rng.uniform(1, 20, (23, 3)).astype(np.float32)
    jt, tt = jtlas.build_tlas(lo, hi), ttlas.build_tlas(lo, hi)
    assert jt.keys() == tt.keys() and all(np.array_equal(jt[k], tt[k]) for k in jt)
    mats = np.stack([np.asarray(m, np.float32) for mdl in tsh.models for m in mdl.matrices])
    roots, ids = np.arange(len(mats)) * 3, np.arange(len(mats)) % 4
    assert np.array_equal(ttl.pack_instances(mats, roots, ids), jtl.pack_instances(mats, roots, ids))


def test_queries_match_jax(many):
    """Closest hit (winner, instance, t, u, v) and any hit (limits around each
    closest t) on the same tables and rays."""
    _, jd, _, tab, o, d, tl = many
    g = [jd["twolevel"][k] for k in ttl.TABLES[:4]]
    ji, jt, ju, jv, jn = (np.asarray(x) for x in jtl.closest_hit_twolevel(*g, o, d, tl))
    eng = tts.upload_gather(tab, "cpu")
    rays = (torch.from_numpy(o), torch.from_numpy(d))
    ti, tt, tu, tv, tn = (x.numpy() for x in ttl.closest_hit(eng, *rays, torch.from_numpy(tl)))
    hit = ji >= 0
    assert 0.5 < hit.mean() < 0.9 and (ti[: N_RAYS // 8] == -1).all()
    np.testing.assert_allclose(tt, jt, rtol=1e-6, atol=1e-4)
    same = (ti == ji) & (tn == jn)
    assert same.mean() >= 0.999 and np.array_equal(ti >= 0, hit)
    np.testing.assert_array_equal(tt[~hit], tl[~hit])
    for a, b in ((tu, ju), (tv, jv)):
        np.testing.assert_allclose(a[same], b[same], rtol=1e-4, atol=1e-5)
    scale = np.random.default_rng(12).uniform(0.5, 1.5, N_RAYS).astype(np.float32)
    tl_any = np.where(hit, jt * scale, tl).astype(np.float32)
    ja = np.asarray(jtl.any_hit_twolevel(*g, o, d, tl_any))
    ta = ttl.any_hit(eng, *rays, torch.from_numpy(tl_any)).numpy()
    assert 0.1 < ja.mean() < 0.9
    np.testing.assert_array_equal(ta, ja)


def test_engine_rule(monkeypatch):
    """The gather engine takes a scene over iwalk's object chunks or object
    triangles, a scene over vwalk's cap that iwalk cannot hold, and any
    scene asked for it by name; asking for vwalk over its cap raises."""
    tsh, _ = tscenes.many_instance_scene(grid=2, subdivisions=1, two_level=True)
    geo = tsh.twolevel
    caps = {k: getattr(tiwalk, k) for k in ("VWALK_MAX_VCH", "IWALK_MAX_TOTAL_CHUNKS")}
    assert geo.engine == "vwalk" and geo.choose("gather") == "gather"
    assert set(geo.device("cpu", engine="gather")) == {"gather"}
    monkeypatch.setattr(tiwalk, "VWALK_MAX_VCH", geo.num_virtual_chunks - 1)
    assert geo.choose() == "iwalk" and geo.choose("iwalk") == "iwalk"
    with pytest.raises(ValueError):
        geo.choose("vwalk")
    monkeypatch.setattr(tiwalk, "IWALK_MAX_TOTAL_CHUNKS", geo.num_chunks - 1)
    assert geo.choose() == geo.choose("iwalk") == "gather"
    for k, v in caps.items():
        monkeypatch.setattr(tiwalk, k, v)
    monkeypatch.setattr(tiwalk, "IWALK_MAX_OBJECT_TRIS", geo.num_object_tris - 1)
    rebuilt = tts.TwoLevelGeometry(geo.models)
    assert rebuilt.engine == "gather" and set(rebuilt.device("cpu")) == {"gather"}
    assert set(rebuilt.device("cpu")["gather"]) == set(ttl.TABLES)


@pytest.mark.parametrize("pt_iwalk,engine", [("0", "gather"), ("1", "vwalk")])
def test_cli_pt_iwalk(monkeypatch, tmp_path, capsys, pt_iwalk, engine):
    """``PT_IWALK=0`` sends a two-level scene through the gather engine, as
    in the JAX package (``twolevel_scene.py:123-130``), over ``PT_VWALK``;
    no kernel launches. It leaves a baked scene alone."""
    monkeypatch.setattr(tscenes, "many_instance_scene",
                        functools.partial(tscenes.many_instance_scene, grid=2, subdivisions=1))
    monkeypatch.setenv("PT_IWALK", pt_iwalk)
    monkeypatch.setenv("PT_VWALK", "0" if pt_iwalk == "0" else "1")
    assert tscene.env_engine(100_000, two_level=False) is None
    n0 = dict(LAUNCHES)
    res = cli.main(["--scene", "many_instance_scene", "--two-level", "--width", "8", "--height", "8",
                    "--spp", "1", "--max-bounces", "2", "--out", str(tmp_path / "x.png"),
                    "--device", "cpu"])
    assert res["engine"] == engine and f"two-level engine: {engine}" in capsys.readouterr().out
    assert torch.isfinite(res["film"]).all() and res["film"][..., :3].mean() > 0
    assert LAUNCHES == n0


def test_from_jax_scene_gather_tables(many):
    """``from_jax_scene`` of the JAX gather dict gives the port's own gather
    tables bit for bit (and its own light tables)."""
    _, jd, tsh, _, _, _, _ = many
    ported = from_jax_scene(jax.tree_util.tree_map(np.asarray, jd), "cpu")
    port = tsh.device("cpu", engine="gather")
    assert ported["tri"] == port["tri"] == {}
    assert set(ported["twolevel"]) == set(port["twolevel"]) == {"gather"}
    for k, v in port["twolevel"]["gather"].items():
        assert torch.equal(ported["twolevel"]["gather"][k], v), k
    for k, v in port["light"]["dense"].items():
        assert torch.equal(ported["light"]["dense"][k], v), k


def test_render_matches_jax():
    """A 16x16, 2-spp two-level render of many_instance_scene through the
    gather engine on both sides (the JAX CPU render's engine): the hit's
    normal interpolated in object space and rotated by its instance, the
    model id from the instance row."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        j, t = _render_both("many_instance_scene", engine=_jax_gather, **MANY_KW)
    _assert_slice_agrees(j, t)
