"""The port's streamed dense engine (``path_tracer_tpu_torch/trace/dense_stream.py``)
against the JAX package's (``path_tracer_tpu/trace/dense_stream.py``, its Pallas
kernels run in interpret mode): host tables bit for bit on a 36,992-triangle
bumpy sphere (3 parts) and a single-part icosphere, the public queries on
the bumpy sphere (the port's CPU path runs the plain versions of the
kernels), a render through the engine on both sides, and the engine rule
(walk, then stream, then raise; ``engine="stream"`` and ``PT_WALK=0``).

Both sides compute the candidate t in the same expression order; XLA may
fuse products and sums into multiply-adds, so t/u/v are held at rtol 2e-4
(the dense engine's tolerance against XLA) and a ray through a shared
triangle edge may resolve to either neighbour. Every JAX query runs at 512
rays (interpret mode compiles once per ray count).
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
from path_tracer_tpu.scene import procedural as jproc
from path_tracer_tpu.scene import triangle as jtri
from path_tracer_tpu.trace import dense_stream as jds
from path_tracer_tpu.trace import walk as jwalk
from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch import scenes as tscenes
from path_tracer_tpu_torch.integrator import wavefront as tw
from path_tracer_tpu_torch.scene import procedural as tproc
from path_tracer_tpu_torch.scene import scene as tscene
from path_tracer_tpu_torch.scene import triangle as ttri
from path_tracer_tpu_torch.trace import dense_stream as tds
from path_tracer_tpu_torch.trace import walk as twalk
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 2e-4, 5e-6
N_JAX = 512  # the one ray count of the JAX queries
DRAGON_KW = {"nu": 96, "nv": 64, "env_h": 32}  # 24,588 world tris, 2 parts


def _pack_both(jpos, jnrm, tpos, tnrm, model):
    assert np.array_equal(jpos, tpos) and np.array_equal(jnrm, tnrm)
    j = jds.pack_dense_stream(jtri.precompute(jpos), jnrm.reshape(-1, 9), model, jpos)
    t = tds.pack_dense_stream(ttri.precompute(tpos), tnrm.reshape(-1, 9), model, tpos)
    return j, t


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) over a 36,992-triangle bumpy sphere: 3 parts."""
    model = (np.arange(2 * 136 * 136) % 7).astype(np.int64)
    j, t = _pack_both(*jproc.bumpy_sphere(nu=136, nv=136), *tproc.bumpy_sphere(nu=136, nv=136), model)
    assert t["meta"]["nparts"] == 3
    return ({k: jnp.asarray(v) for k, v in j.items() if k != "meta"},
            {k: torch.from_numpy(t[k]) for k in tds.TABLES})


def _rays(n, seed):
    """Half the rays aimed at the sphere from outside, half from inside in
    random directions (tests/test_dense_stream.py's mix)."""
    rng = np.random.default_rng(seed)
    o1 = rng.standard_normal((n // 2, 3))
    o1 = o1 / np.linalg.norm(o1, axis=1, keepdims=True) * 3.0
    d1 = -o1 + rng.standard_normal((n // 2, 3)) * 0.15
    o2 = (rng.random((n - n // 2, 3)) - 0.5) * 2.0
    d2 = rng.standard_normal((n - n // 2, 3))
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2])
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _pad(x, value):
    """``x`` padded along axis 0 to the JAX queries' 512 rays."""
    return np.concatenate([x, np.full((N_JAX - x.shape[0], *x.shape[1:]), value, x.dtype)])


def _closest(engines, o, d, tl):
    """The public closest hit on both sides; the JAX rays are padded to
    512 with dead lanes (t_limit 0), which no live lane's result sees."""
    je, te = engines
    n = o.shape[0]
    jo = [jnp.asarray(_pad(x, v)) for x, v in ((o, 0.0), (d, 0.0), (tl, 0.0))]
    j = [np.asarray(x)[:n] for x in jds.dense_stream_closest_hit_shade(je, *jo)]
    t = [x.numpy() for x in tds.dense_stream_closest_hit_shade(te, *map(torch.from_numpy, (o, d, tl)))]
    return j, t


def _any(engines, o, d, tl):
    je, te = engines
    n = o.shape[0]
    jo = [jnp.asarray(_pad(x, v)) for x, v in ((o, 0.0), (d, 0.0), (tl, 0.0))]
    j = np.asarray(jds.dense_stream_any_hit(je, *jo))[:n]
    return j, tds.dense_stream_any_hit(te, *map(torch.from_numpy, (o, d, tl))).numpy()


def _on_edge(r):
    """Lanes whose hit lies on a triangle edge (a barycentric within 1e-6 of
    0): a ray through a shared edge is a knife edge, where a fused
    multiply-add on the JAX side can flip a sign test."""
    return (r[0] >= 0) & (np.minimum(np.minimum(r[2], r[3]), 1.0 - r[2] - r[3]) < 1e-6)


def _assert_closest_agrees(j, t, edge_ok=False):
    assert t[0].dtype == np.int32 and t[5].dtype == np.int32
    same = t[0] == j[0]  # winners, in soup order
    if edge_ok:
        assert (same | _on_edge(j) | _on_edge(t)).all() and (~same).sum() <= 2
        j, t = [x[same] for x in j], [x[same] for x in t]
    else:
        assert same.all()
    np.testing.assert_array_equal(t[5], j[5])  # model ids
    hit = j[0] >= 0
    assert hit.sum() > 100
    for a, b in zip(t[1:5], j[1:5]):  # t, u, v, normal
        np.testing.assert_allclose(a[hit], b[hit], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(t[1][~hit], j[1][~hit])  # t = t_limit on a miss


@pytest.mark.parametrize("shape", ["bumpy_3_parts", "icosphere_1_part"])
def test_pack_dense_stream_bit_equal(shape):
    """Every table the port shares with the JAX package equals the JAX one
    bit for bit (the MXU weight table ``w`` is dropped), ``meta`` included;
    the port adds its group boxes ``qab`` (`pack_qab`)."""
    if shape == "bumpy_3_parts":
        args = (*jproc.bumpy_sphere(nu=136, nv=136), *tproc.bumpy_sphere(nu=136, nv=136))
        model = (np.arange(36992) % 7).astype(np.int64)
    else:
        args = (*jproc.icosphere(subdivisions=3), *tproc.icosphere(subdivisions=3))
        model = None
    j, t = _pack_both(*args, model)
    assert set(t) == set(j) - {"w"} | {"qab"}
    assert t["meta"] == j["meta"] and t["meta"]["nparts"] == (3 if model is not None else 1)
    np.testing.assert_array_equal(t["qab"], tds.pack_qab(args[2], t["aux"].shape[0]))
    for k in tds.JAX_TABLES:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert (t["aux"][t["meta"]["n_tris"]:] == 0).all()  # pad rows never hit


def test_closest_matches_jax(engines):
    """512 rays: winners and model ids equal, t/u/v/normal within RTOL;
    `dense_stream_closest_hit` is the first four of them."""
    o, d = _rays(N_JAX, seed=1)
    tl = np.full(N_JAX, np.inf, np.float32)
    j, t = _closest(engines, o, d, tl)
    _assert_closest_agrees(j, t)
    short = tds.dense_stream_closest_hit(engines[1], *map(torch.from_numpy, (o, d, tl)))
    for a, b in zip(short, t):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("scale", [0.99, 1.01])
def test_any_hit_window_matches_jax(engines, scale):
    """Shadow windows just short of and just past each ray's closest hit:
    flags equal to the JAX engine's, and to the closest hit's verdict."""
    o, d = _rays(N_JAX, seed=2)
    ti, tt = tds.dense_stream_closest_hit_shade(engines[1], torch.from_numpy(o), torch.from_numpy(d),
                                                torch.full((N_JAX,), torch.inf))[:2]
    hit = (ti >= 0).numpy()
    lim = np.where(hit, tt.numpy() * scale, 1e-3).astype(np.float32)
    j, t = _any(engines, o, d, lim)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, hit if scale > 1 else np.zeros_like(hit))


def test_ragged_dead_and_nan_lanes(engines):
    """333 lanes (not a multiple of the 128-ray block) with dead, NaN and
    finite-limit lanes: the closest hit equals the JAX engine's but on a
    ray through a shared edge; any-hit flags are equal where t_limit > 0;
    dead and NaN lanes never hit."""
    rng = np.random.default_rng(6)
    o, d = _rays(333, seed=5)
    tl = np.full(333, np.inf, np.float32)
    lanes = rng.permutation(333)
    tl[lanes[:30]] = 0.0
    tl[lanes[30:40]] = -1.0
    tl[lanes[40:80]] = rng.uniform(0.5, 3.0, 40)
    o[lanes[80:90]] = np.nan
    d[lanes[90:100]] = np.nan
    j, t = _closest(engines, o, d, tl)
    _assert_closest_agrees(j, t, edge_ok=True)
    dead = ~(np.isfinite(o).all(1) & np.isfinite(d).all(1) & (tl > 0))
    assert (t[0][dead] == -1).all()
    ja, ta = _any(engines, o, d, tl)
    pos = tl > 0
    assert ((ta == ja) | _on_edge(j) | _on_edge(t))[pos].all() and (ta != ja)[pos].sum() <= 2
    assert not ta[dead].any() and ta.any()


def test_render_sample_stream_matches_jax():
    """dragon_scene cut to 24,588 world tris, its world queries through the
    streamed engine on both sides (the JAX dict gets ``tri["dense_stream"]``
    by hand: its ``Scene.device()`` packs it only on a TPU), 16x16, 2 spp,
    8 bounces; compared as the other whole-slice tests compare
    (``tests/test_torch_render.py``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        sh, cam = jscenes.dragon_scene(**DRAGON_KW)
    jd = sh.device()
    t = sh.num_world_tris
    tables = jds.pack_dense_stream(sh.tri, sh.tri["normals"].reshape(t, 9), sh.tri["model"],
                                   sh.tri["positions"])
    jd["tri"]["dense_stream"] = {k: jnp.asarray(v) for k, v in tables.items() if k != "meta"}
    ndc, org = cam.view_proj_inverse(), cam.origin
    args = dict(max_bounces=8, spp=2, mtypes=sh.active_mtypes, any_volumes=sh.has_volumes)
    j = [np.asarray(x) for x in jrender(jd, jnp.asarray(ndc), jnp.asarray(org), 0, 16, 16, **args)]
    td = tscene.from_jax_scene(jax.tree_util.tree_map(np.asarray, jd), "cpu")
    assert "stream" in td["tri"] and "walk" not in td["tri"] and "dense" not in td["tri"]
    for k in tds.JAX_TABLES:
        np.testing.assert_array_equal(td["tri"]["stream"][k].numpy(), tables[k], err_msg=k)
    # the port's group boxes, rebuilt from the soup's positions
    np.testing.assert_array_equal(td["tri"]["stream"]["qab"].numpy(),
                                  tds.pack_qab(sh.tri["positions"], tables["aux"].shape[0]))
    n0 = dict(LAUNCHES)
    t = [x.numpy() for x in tw.render_sample(td, torch.from_numpy(ndc), torch.from_numpy(org), 0, 16, 16,
                                             **args)]
    assert LAUNCHES == n0  # CPU tensors take the plain versions
    jr, tr = j[0], t[0]
    assert np.isfinite(tr).all() and tr.mean() > 0
    assert np.isclose(tr, jr, rtol=1e-3, atol=1e-4).all(axis=1).mean() >= 0.95
    assert abs(tr.mean() - jr.mean()) <= 0.01 * jr.mean()
    np.testing.assert_allclose(t[3].sum(axis=0), j[3].sum(axis=0), rtol=0.01)
    assert (t[2] == j[2].astype(np.int64)).mean() >= 0.99


def test_engine_rule_matches_jax():
    """The baked world engine by size, as the JAX package's TPU build picks
    it: dense up to 16,384 tris, walk up to 1,572,864, the streamed engine up
    to 2,000,000 (soups between the two limits used to raise in
    ``pack_walk``), then the stack BVH (such soups used to raise);
    ``engine="stream"`` at any size up to the stream's limit."""
    assert (twalk.WALK_PARTS_MAX_TRIS, tds.DENSE_STREAM_MAX_TRIS) == (
        jwalk.WALK_PARTS_MAX_TRIS, jds.DENSE_STREAM_MAX_TRIS)
    assert (tds.PART_TRIS, tds.CH, tds.SBLK) == (jds.PART_TRIS, jds.CH, jds.SBLK)
    rule = tscene.world_engine
    assert [rule(n) for n in (1, 16_384, 16_385, 1_572_864, 1_572_865, 2_000_000)] == [
        "dense", "dense", "walk", "walk", "stream", "stream"]
    assert rule(100, "stream") == rule(2_000_000, "stream") == "stream"
    for n, engine in ((2_000_001, None), (2_000_001, "stream")):
        assert rule(n, engine) == "bvh"
    for engine in ("walk", "vwalk"):
        with pytest.raises(ValueError):
            rule(100, engine)


def test_engine_rule_on_a_scene(monkeypatch):
    """A 24,588-triangle soup with the limits patched small: the walk, then
    the streamed engine (no walk packed), then the stack BVH (a scene built
    under that limit; one built before it cannot give the tree it did not
    keep); ``engine="stream"`` and ``PT_WALK=0`` (`env_engine`) pick the
    streamed engine below the walk's limit."""
    sh, _ = tscenes.dragon_scene(**DRAGON_KW)
    assert sh.num_world_tris == 24588
    assert set(sh.device("cpu")["tri"]) >= {"walk"}
    stream = sh.device("cpu", engine="stream")["tri"]
    assert "stream" in stream and not {"walk", "dense"} & set(stream)
    assert tds.num_parts(stream["stream"]) == 2
    monkeypatch.setattr(tscene, "WALK_PARTS_MAX_TRIS", 20_000)
    tri = sh.device("cpu")["tri"]
    assert "stream" in tri and "walk" not in tri
    for k in tds.TABLES:
        assert torch.equal(tri["stream"][k], stream["stream"][k]), k
    monkeypatch.setattr(tds, "DENSE_STREAM_MAX_TRIS", 20_000)
    with pytest.raises(ValueError):
        sh.device("cpu")
    tri = tscenes.dragon_scene(**DRAGON_KW)[0].device("cpu", engine="stream")["tri"]
    assert "bvh" in tri and not {"walk", "stream", "dense"} & set(tri)
    monkeypatch.setenv("PT_WALK", "0")
    assert tscene.env_engine(24588) == "stream"
    assert tscene.env_engine(16384) is None and tscene.env_engine(24588, two_level=True) is None
    monkeypatch.setenv("PT_WALK", "1")
    assert tscene.env_engine(24588) is None


@pytest.mark.parametrize("pt_walk", ["0", "1"])
def test_cli_pt_walk(monkeypatch, tmp_path, capsys, pt_walk):
    """The CLI on the 24,588-triangle dragon: ``PT_WALK=0`` renders through
    the streamed engine, the default through the walk; the engine is
    printed, and CPU tensors launch no kernel."""
    monkeypatch.setattr(tscenes, "dragon_scene", functools.partial(tscenes.dragon_scene, **DRAGON_KW))
    monkeypatch.setenv("PT_WALK", pt_walk)
    n0 = dict(LAUNCHES)
    res = cli.main(["--scene", "dragon_scene", "--width", "8", "--height", "8", "--spp", "1",
                    "--max-bounces", "2", "--out", str(tmp_path / "x.png"), "--device", "cpu"])
    engine = "stream" if pt_walk == "0" else "walk"
    assert res["engine"] == engine and f"world engine: {engine}" in capsys.readouterr().out
    assert torch.isfinite(res["film"]).all() and res["film"][..., :3].mean() > 0
    assert LAUNCHES == n0
