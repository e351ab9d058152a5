"""The port's scene inputs and host runtime against the JAX package: OBJ
parsing (``scene/objio.py``), the PNG decoder and writer and the
environment lookup (``scene/envmap.py``), JSON scenes (``utils/config.py``), env_sphere_scene,
renders of both against the JAX render, the CLI's ``.json`` scenes,
``--fov``, ``--profile-dir`` and ``--retries``, and ``utils/debug.py``,
``utils/disk_cache.py`` and ``utils/profiling.py``.

Both packages build with their NumPy builders (``tests/torch_builders.py``),
so host tables are compared bit for bit. The PNG decoder is held to Pillow
(the JAX package's loader) byte for byte on every colour type and filter
type (``tests/test_torch_images.py`` holds the rest of the image codecs).
Renders are held to ``tests/test_torch_render.py``'s slice checks.
"""

import dataclasses
import importlib.util
import io
import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_render import _assert_slice_agrees, _jax_scene_with_dense_pl

from path_tracer_tpu import scenes as jscenes
from path_tracer_tpu.integrator.wavefront import render_sample as jrender
from path_tracer_tpu.scene import envmap as jenv
from path_tracer_tpu.scene import objio as jobjio
from path_tracer_tpu.utils import config as jconfig
from path_tracer_tpu.utils import profiling as jprof
from path_tracer_tpu_torch import cli
from path_tracer_tpu_torch import scenes as tscenes
from path_tracer_tpu_torch.camera import Camera
from path_tracer_tpu_torch.film import load_checkpoint
from path_tracer_tpu_torch.integrator import wavefront as tw
from path_tracer_tpu_torch.scene import envmap as tenv
from path_tracer_tpu_torch.scene import objio, procedural
from path_tracer_tpu_torch.scene.scene import from_jax_scene
from path_tracer_tpu_torch.utils import config as tconfig
from path_tracer_tpu_torch.utils import debug, disk_cache, profiling
from torch_builders import numpy_builders  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET_SCENE = os.path.join("assets", "asset_scene.json")  # its paths are relative to the repo
W = H = 16
SPP, BOUNCES = 2, 8
DRAGON_KW = {"nu": 96, "nv": 64, "env_h": 32}
MANY_KW = {"grid": 3, "subdivisions": 1}


# --- OBJ ---


@pytest.mark.parametrize("which", ["knot", "quads"])
def test_load_obj_matches_jax(tmp_path, which):
    path = os.path.join(REPO, "assets", "knot.obj")
    if which == "quads":
        path = tmp_path / "quads.obj"
        path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 3\n"
                        "f -4//-1 -3//-1 -2//-1 -1//-1\nvt 0 0\ng part\n"
                        "v 0 0 1\nv 2 0 1\nv 2 2 1\nv 0 2 1\nv 1 3 1\nf 5/1 6/1 7/1 8/1 9/1\n")
    got, want = objio.load_obj(path), jobjio.load_obj(path)
    assert got[0].shape == want[0].shape and got[0].shape[0] == (6912 if which == "knot" else 5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_save_obj_round_trip(tmp_path):
    pos, nrm = procedural.icosphere((0.0, 1.0, 0.0), 2.0, 1)
    objio.save_obj(tmp_path / "n.obj", pos, nrm)
    jobjio.save_obj(tmp_path / "j.obj", pos, nrm)
    assert (tmp_path / "n.obj").read_text() == (tmp_path / "j.obj").read_text()
    got_pos, got_nrm = objio.load_obj(tmp_path / "n.obj")
    np.testing.assert_array_equal(got_pos, pos)
    np.testing.assert_allclose(got_nrm, nrm / np.linalg.norm(nrm, axis=-1, keepdims=True), atol=1e-6)
    objio.save_obj(tmp_path / "f.obj", pos)
    np.testing.assert_array_equal(objio.load_obj(tmp_path / "f.obj")[0], pos)


# --- PNG ---


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(px: np.ndarray, bpp: int) -> bytes:
    """Scanlines ``px [H, W*bpp]`` with filter type ``y % 5`` on row y,
    written by hand, so every type occurs."""
    out, prior = bytearray(), np.zeros(px.shape[1], np.int64)
    for y, row in enumerate(px.astype(np.int64)):
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        ft = y % 5
        pred = [0, a, prior, (a + prior) >> 1, _paeth(a, prior, c)][ft]
        out.append(ft)
        out += ((row - pred) & 255).astype(np.uint8).tobytes()
        prior = row
    return bytes(out)


def _png(px: np.ndarray, ctype: int, palette=None, depth=8, interlace=0) -> bytes:
    h, w = px.shape[0], px.shape[1]
    bpp = px.shape[2] if px.ndim == 3 else 1

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + (chunk(b"PLTE", palette.tobytes()) if palette is not None else b"")
            + chunk(b"IDAT", zlib.compress(_filtered(px.reshape(h, w * bpp), bpp)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_decode_png_matches_pillow(ctype):
    """Every colour type at 8 bits, rows of all five filter types (and
    bytes that wrap), against Pillow's ``convert("RGB")``."""
    rng = np.random.default_rng(ctype)
    h, w = 11, 9
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (37, 3), dtype=np.uint8)
        px = rng.integers(0, 37, (h, w, 1), dtype=np.uint8)
    else:
        px = rng.integers(0, 256, (h, w, {0: 1, 2: 3, 4: 2, 6: 4}[ctype]), dtype=np.uint8)
    data = _png(px, ctype, palette)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = tenv.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_load_image_matches_jax(tmp_path):
    """``assets/sky.png`` (512x256 RGB) and a written RGBA file, decoded and
    linearized bit for bit as the JAX package's Pillow loader does."""
    rgba = tmp_path / "rgba.png"
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (7, 5, 4), dtype=np.uint8),
                    "RGBA").save(rgba)
    for path in (os.path.join(REPO, "assets", "sky.png"), str(rgba)):
        got, want = tenv.load_image(path), jenv.load_image(path)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert tenv.load_image(os.path.join(REPO, "assets", "sky.png")).shape == (256, 512, 3)


def test_save_image_round_trip(tmp_path):
    img = np.random.default_rng(5).uniform(-0.2, 1.2, (6, 10, 3)).astype(np.float32)
    tenv.save_image(tmp_path / "t.png", img)
    jenv.save_image(tmp_path / "j.png", img)
    got = np.asarray(Image.open(tmp_path / "t.png").convert("RGB"))
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "j.png").convert("RGB")))
    np.testing.assert_array_equal(tenv.load_image(tmp_path / "t.png"), jenv.load_image(tmp_path / "j.png"))


@pytest.mark.parametrize("case", ["avif", "arithmetic-jpeg", "jpeg-in-tiff"])
def test_unsupported_images_raise(tmp_path, case):
    """What the port does not read raises, naming the file: an AVIF, an
    arithmetic-coded JPEG (its SOF0 marker patched to SOF9) and a TIFF of
    JPEG strips. (JPEG, PNG, WebP and the other raster formats load:
    ``tests/test_torch_images.py``, ``tests/test_torch_formats.py``,
    ``tests/test_torch_webp.py``.)"""
    path = tmp_path / f"{case}.img"
    px = np.zeros((4, 4, 3), np.uint8)
    if case == "avif":
        Image.fromarray(px).save(path, "AVIF")
        what = "AVIF"
    elif case == "arithmetic-jpeg":
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "JPEG")
        path.write_bytes(buf.getvalue().replace(b"\xff\xc0", b"\xff\xc9", 1))
        what = "arithmetic-coded"
    else:
        Image.fromarray(px).save(path, "TIFF", compression="jpeg")
        what = "JPEG TIFF"
    with pytest.raises(ValueError, match=what) as err:
        tenv.load_image(path)
    assert str(path) in str(err.value)


# --- the environment lookup ---


def _directions(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_sample_environment_matches_jax_both_lookups():
    """The port's four-fetch lookup on the decoded ``assets/sky.png``
    agrees with the JAX package's lookups, without and with its quad table
    (which give the same bits), within f32 rounding of the texel
    coordinates (its atan2 / asin round differently in the last bit)."""
    sky = tenv.load_image(os.path.join(REPO, "assets", "sky.png"))
    d = _directions(4096, 1)
    got = tenv.sample_environment(torch.from_numpy(sky), torch.from_numpy(d)).numpy()
    jplain = np.asarray(jenv.sample_environment(jnp.asarray(sky), jnp.asarray(d)))
    jq = np.asarray(jenv.sample_environment(jnp.asarray(sky), jnp.asarray(d),
                                            jnp.asarray(jenv.build_quad_table(sky))))
    np.testing.assert_array_equal(jq, jplain)
    np.testing.assert_allclose(got, jq, rtol=1e-4, atol=1e-6)


def test_large_sky_without_quad_table():
    """A sky above the JAX package's quad threshold (65,536 texels): the
    port's device dict has no quad table, ``from_jax_scene`` drops the JAX
    dict's ``env_quad``, and a render from that dict is bit-equal to one
    from the port's own."""
    sh, cam = tscenes.env_sphere_scene(env_size=256)  # 256 x 512 texels
    own = sh.device("cpu")
    assert "env_quad" not in own
    jsh, _ = jscenes.env_sphere_scene(env_size=256)
    jd = jax.tree_util.tree_map(np.asarray, jsh.device())
    assert "env_quad" in jd
    carried = from_jax_scene(jd, "cpu")
    assert "env_quad" not in carried and torch.equal(carried["env"], own["env"])
    args = (torch.from_numpy(cam.view_proj_inverse()), torch.from_numpy(cam.origin), 0, 8, 8)
    kw = dict(max_bounces=4, has_lights=False, mtypes=sh.active_mtypes, any_volumes=False)
    a, b = tw.render_sample(own, *args, **kw), tw.render_sample(carried, *args, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- JSON scenes ---


def _ball_scene(tmp_path, camera=True):
    """``tests/test_assets_e2e.py``'s scene: an icosphere OBJ in the Cornell
    walls under a 32x64 PNG sky, written by the port."""
    pos, nrm = procedural.icosphere((0.0, 250.0, 0.0), 140.0, 2)
    objio.save_obj(tmp_path / "ball.obj", pos, nrm)
    sky = np.zeros((32, 64, 3), np.float32)
    sky[:16] = (0.2, 0.4, 0.9)
    sky[16:] = (0.3, 0.25, 0.2)
    tenv.save_image(tmp_path / "sky.png", sky)
    desc = {
        "env": str(tmp_path / "sky.png"),
        "models": [
            {"primitive": {"type": "cornell_walls"},
             "material": {"type": "lambertian", "albedo": [0.73, 0.73, 0.73]}},
            {"primitive": {"type": "cornell_light"},
             "material": {"type": "emissive", "emitted": [15, 15, 15]}},
            {"obj": str(tmp_path / "ball.obj"),
             "material": {"type": "ggx_metal", "colour": [0.9, 0.6, 0.3], "roughness": 0.3},
             "instances": [{"rotation_y": 0.5, "translation": [0, -80, 0]}]},
        ],
    }
    if camera:
        desc["camera"] = {"origin": [0, 277.5, 1100], "look_at": [0, 277.5, 0], "fov": 55.0}
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(desc))
    return str(path)


def _assert_scenes_equal(jsh, tsh):
    assert tsh.num_world_tris == jsh.num_world_tris and tsh.has_lights == jsh.has_lights
    assert tsh.active_mtypes == jsh.active_mtypes and tsh.has_volumes == jsh.has_volumes
    for tab in ("tri", "light", "mat"):
        a, b = getattr(jsh, tab), getattr(tsh, tab)
        assert (a is None) == (b is None), tab
        for k in (k for k in b or () if k in a):
            assert a[k].dtype == b[k].dtype, (tab, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{tab}.{k}")
    np.testing.assert_array_equal(jsh.env, tsh.env)


def test_asset_scene_matches_jax(monkeypatch):
    """``assets/asset_scene.json`` (the Cornell walls and light, two knot
    instances, ``sky.png``): host tables and camera equal to the JAX
    package's; 6 + 2 + 2 x 6,912 = 13,832 world tris, the dense kernels'."""
    monkeypatch.chdir(REPO)
    jsh, tsh = jconfig.load_scene_json(ASSET_SCENE), tconfig.load_scene_json(ASSET_SCENE)
    assert tsh.num_world_tris == 13832 and tsh.env.shape == (256, 512, 3)
    _assert_scenes_equal(jsh, tsh)
    jcam, tcam = jconfig.load_camera_json(ASSET_SCENE, 16 / 9), tconfig.load_camera_json(ASSET_SCENE, 16 / 9)
    np.testing.assert_array_equal(tcam.view_proj_inverse(), jcam.view_proj_inverse())
    np.testing.assert_array_equal(tcam.origin, jcam.origin)
    assert tcam.fov == jcam.fov == 60.0
    assert tconfig.load_scene_json(ASSET_SCENE, two_level=True).two_level


@pytest.mark.parametrize("bad", [{"material": {"type": "velvet"}},
                                 {"primitive": {"type": "torus"}}], ids=["material", "primitive"])
def test_unknown_types_raise(tmp_path, bad):
    model = {"primitive": {"type": "cornell_light"}, "material": {"type": "emissive", "emitted": [1, 1, 1]}}
    model.update(bad)
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"models": [model]}))
    with pytest.raises(ValueError, match="unknown"):
        tconfig.load_scene_json(path)
    with pytest.raises(ValueError, match="unknown"):
        jconfig.load_scene_json(path)


def test_every_json_type_matches_jax(tmp_path):
    """Every material and primitive type of the schema, a volume and
    ``two_level``, against the JAX loader."""
    vol = {"absorption": [0.4, 0.6, 0.7], "k": 0.1, "c": 0.005, "g": 0.6}
    mats = [{"type": "lambertian", "albedo": [0.5, 0.4, 0.3]}, {"type": "emissive", "emitted": [4, 4, 4]},
            {"type": "specular"}, {"type": "ggx_metal", "colour": [0.9, 0.6, 0.3], "roughness": 0.3},
            {"type": "ggx_dielectric", "colour": [0.9, 0.9, 0.9], "roughness": 0.2, "volume": vol},
            {"type": "dielectric", "ior": 1.33}]
    prims = [{"type": "icosphere", "center": [0, 100, 0], "radius": 50, "subdivisions": 1},
             {"type": "box", "center": [50, 50, 50], "half_extents": [20, 30, 40]},
             {"type": "cornell_walls"}, {"type": "cornell_left"}, {"type": "cornell_right"},
             {"type": "cornell_light"}]
    models = [{"primitive": p, "material": m,
               "instances": [{"rotation_y": 0.3 * i, "translation": [i, 0, 0]}] if i % 2 else []}
              for i, (p, m) in enumerate(zip(prims, mats))]
    path = tmp_path / "all.json"
    path.write_text(json.dumps({"models": models}))
    _assert_scenes_equal(jconfig.load_scene_json(path), tconfig.load_scene_json(path))
    path.write_text(json.dumps({"models": models, "two_level": True}))
    assert tconfig.load_scene_json(path).two_level


# --- renders against the JAX render ---


def _render_pair(jsh, tsh, cam):
    """The JAX render (Pallas dense kernels in interpret mode) and the
    port's, each of its own host scene."""
    ndc, org = cam.view_proj_inverse(), cam.origin
    args = dict(max_bounces=BOUNCES, spp=SPP, mtypes=jsh.active_mtypes,
                any_volumes=jsh.has_volumes, has_lights=jsh.has_lights)
    j = jrender(_jax_scene_with_dense_pl(jsh), jnp.asarray(ndc), jnp.asarray(org), 0, W, H, **args)
    t = tw.render_sample(tsh.device("cpu"), torch.from_numpy(ndc), torch.from_numpy(org), 0, W, H,
                         **args)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def test_env_sphere_scene_renders_like_jax():
    """A mirror icosphere (1,280 tris) with no lights: every path ends in
    the environment."""
    jsh, _ = jscenes.env_sphere_scene()
    tsh, cam = tscenes.env_sphere_scene()
    assert not tsh.has_lights and tsh.num_world_tris == 1280
    _assert_scenes_equal(jsh, tsh)
    _assert_slice_agrees(*_render_pair(jsh, tsh, cam))


def test_json_scene_renders_like_jax(tmp_path):
    path = _ball_scene(tmp_path)
    jsh, tsh = jconfig.load_scene_json(path), tconfig.load_scene_json(path)
    assert tsh.models[2].positions.shape[0] == 320 and tsh.env.shape == (32, 64, 3)
    _assert_scenes_equal(jsh, tsh)
    _assert_slice_agrees(*_render_pair(jsh, tsh, tconfig.load_camera_json(path, 1.0)))


# --- the CLI on the CPU ---


def _cli(path, tmp_path, *extra):
    return cli.main(["--scene", path, "--width", "8", "--height", "8", "--spp", "2",
                     "--max-bounces", "3", "--device", "cpu", "--out", str(tmp_path / "out.png"),
                     *extra])


def _film(sh, cam, spp=2, bounces=3, w=8, h=8):
    rad, _, _, _ = tw.render_sample(sh.device("cpu"), torch.from_numpy(cam.view_proj_inverse()),
                                    torch.from_numpy(cam.origin), 0, w, h, max_bounces=bounces,
                                    spp=spp, has_lights=sh.has_lights, mtypes=sh.active_mtypes,
                                    any_volumes=sh.has_volumes)
    return torch.cat([rad, torch.full((w * h, 1), float(spp))], dim=1).reshape(h, w, 4)


@pytest.mark.parametrize("camera", [True, False], ids=["camera", "fov"])
def test_cli_json_scene(tmp_path, camera):
    """A ``.json`` scene through the CLI: its camera, or without one the
    Cornell view at ``--fov``."""
    path = _ball_scene(tmp_path, camera)
    res = _cli(path, tmp_path, "--fov", "33")
    assert (tmp_path / "out.png").exists() and res["engine"] == "dense"
    cam = tconfig.load_camera_json(path, 1.0) if camera else Camera(
        (0.0, 277.5, 1300.0), (0.0, 277.5, 0.0), fov=33.0, aspect_ratio=1.0)
    assert torch.equal(res["film"], _film(tconfig.load_scene_json(path), cam))
    assert set(res["phases"]) == {"scene build", "upload", "trace"}


def test_cli_unknown_scene_name_exits():
    with pytest.raises(SystemExit):
        cli.main(["--scene", "nope_scene", "--device", "cpu"])


def test_cli_profile_dir_writes_a_trace(tmp_path):
    res = cli.main(["--scene", "env_sphere_scene", "--width", "4", "--height", "4", "--spp", "1",
                    "--max-bounces", "2", "--device", "cpu", "--out", str(tmp_path / "o.png"),
                    "--profile-dir", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / profiling.TRACE_FILE).read_text())
    assert len(trace["traceEvents"]) > 0 and res["spp"] == 1


def _flaky(monkeypatch, fail):
    """Patch ``render_sample`` so that call ``i`` raises where ``fail(i)``;
    ``time.sleep`` records its seconds instead of sleeping."""
    calls, sleeps = [], []
    real = tw.render_sample

    def render_sample(*a, **kw):
        calls.append(a[3])
        if fail(len(calls) - 1):
            raise RuntimeError("device error (test)")
        return real(*a, **kw)

    monkeypatch.setattr(tw, "render_sample", render_sample)
    monkeypatch.setattr(cli.time, "sleep", sleeps.append)
    return calls, sleeps


def test_cli_retry_after_one_fault(tmp_path, monkeypatch):
    path = _ball_scene(tmp_path)
    want = _cli(path, tmp_path)["film"]
    calls, sleeps = _flaky(monkeypatch, lambda i: i == 0)
    got = _cli(path, tmp_path, "--retries", "2")["film"]
    assert calls == [0, 0] and sleeps == [cli.RETRY_BACKOFF_S]
    assert torch.equal(got, want)


def test_cli_gives_up_after_retries(tmp_path, monkeypatch):
    """Sample 0 renders, sample 1 fails on every attempt: the checkpoint
    holds sample 0's film at next sample 1, then the error is raised."""
    path = _ball_scene(tmp_path)
    one = _cli(path, tmp_path, "--spp", "1")["film"]
    calls, sleeps = _flaky(monkeypatch, lambda i: i > 0)
    ckpt = tmp_path / "c.npz"
    with pytest.raises(RuntimeError, match="test"):
        _cli(path, tmp_path, "--retries", "2", "--checkpoint", str(ckpt), "--checkpoint-every", "1")
    assert calls == [0, 1, 1, 1] and sleeps == [cli.RETRY_BACKOFF_S, 2 * cli.RETRY_BACKOFF_S]
    film, start = load_checkpoint(ckpt, "cpu")
    assert start == 1 and torch.equal(film, one)


# --- utils ---


SCENE_KW = {"dragon_scene": DRAGON_KW, "many_instance_scene": MANY_KW}


@pytest.mark.parametrize("name", cli.SCENES)
def test_validate_scene_passes(name):
    sh, _ = getattr(tscenes, name)(**SCENE_KW.get(name, {}))
    debug.validate_scene(sh)


@pytest.mark.parametrize("fault", ["box", "leaves", "env"])
def test_validate_scene_catches(fault):
    sh, _ = tscenes.cornell_diffuse()
    if fault == "box":
        i = int(np.flatnonzero(sh.bvh["c0_count"] != -1)[0])
        sh.bvh["c0_min"][i, 0] = sh.bvh["c0_max"][i, 0] + 1.0
    elif fault == "leaves":
        leaf = int(np.flatnonzero(sh.bvh["c1_count"] > 0)[0])
        sh.bvh["c1_idx"][leaf] = sh.bvh["c0_idx"][np.flatnonzero(sh.bvh["c0_count"] > 0)[0]]
    else:
        sh.env = np.full((2, 2, 3), np.nan, np.float32)
    with pytest.raises(debug.SceneValidationError):
        debug.validate_scene(sh)


def test_debug_render():
    sh, cam = tscenes.cornell_diffuse()
    film = debug.debug_render(sh, cam, 8, 8, spp=1, device="cpu", max_bounces=3)
    assert film.shape == (8, 8, 4) and bool((film[..., 3] == 1).all())
    with pytest.raises(debug.SceneValidationError):
        debug.validate_render_outputs(torch.tensor([[float("nan"), 0.0, 0.0]]), torch.zeros(1, 3),
                                      torch.zeros(1), torch.zeros(1, 2))


@pytest.fixture(scope="module")
def engines():
    """{kind: (tables, number of soup tris, soup positions or None)}."""
    sh, _ = tscenes.dragon_scene(**DRAGON_KW)
    pos = sh.tri["positions"]
    out = {"walk": (sh.device("cpu")["tri"]["walk"], sh.num_world_tris, pos),
           "stream": (sh.device("cpu", engine="stream")["tri"]["stream"], sh.num_world_tris, pos)}
    two, _ = tscenes.many_instance_scene(**MANY_KW, two_level=True)
    n = sum(m.positions.shape[0] for m in two.models)
    for e in ("vwalk", "iwalk"):
        out[e] = (two.device("cpu", engine=e)["twolevel"]["iwalk"], n, None)
    return out


@pytest.mark.parametrize("kind", ["walk", "vwalk", "iwalk", "stream"])
def test_validate_walk_engine(engines, kind):
    eng, n, pos = engines[kind]
    debug.validate_walk_engine(eng, n, pos)
    bad = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in eng.items()}
    if kind == "stream":
        bad["qab"][1, 3:6] = bad["qab"][1, 0:3] - 1.0  # a group box turned inside out
    elif kind == "iwalk":
        bad["ocb"][0, 0:3] += 1e3  # an object chunk box moved off its part's
        bad["ocb"][0, 3:6] += 1e3
    else:
        bad["cb_oct"][3, 0, 0] = bad["cb_oct"][3, 3, 0] + 1.0  # min > max in one octant
    with pytest.raises(debug.SceneValidationError):
        debug.validate_walk_engine(bad, n, pos)


def test_validate_walk_engine_catches_a_box_off_its_rows(engines):
    eng, n, pos = engines["walk"]
    bad = dict(eng, cb_oct=eng["cb_oct"].clone())
    for o in range(8):  # chunk slot 0's box flattened to its low x, in every octant's order
        col = int(torch.nonzero(eng["ord_oct"][o] == 0)[0, 0])
        bad["cb_oct"][o, 3, col] = bad["cb_oct"][o, 0, col]
    debug.validate_walk_engine(bad, n, None)  # still ordered: only the rows show it
    with pytest.raises(debug.SceneValidationError):
        debug.validate_walk_engine(bad, n, pos)


def _module(path, body):
    path.write_text(body)
    spec = importlib.util.spec_from_file_location(f"gen_{abs(hash(body))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cached_arrays(tmp_path, monkeypatch):
    """A hit reads what the miss wrote; an edited source misses; entries
    are named by module and function; ``PT_HOST_CACHE=0`` calls through;
    everything is written under the cache directory given."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("PT_HOST_CACHE", str(cache))
    body = "import numpy as np\nCALLS = []\ndef gen(n):\n    CALLS.append(n)\n    return np.arange(n), np.ones(n)\n"
    mod = _module(tmp_path / "gen.py", body)
    a = disk_cache.cached_arrays(mod.gen, 5)
    b = disk_cache.cached_arrays(mod.gen, 5)
    assert mod.CALLS == [5] and all(np.array_equal(x, y) for x, y in zip(a, b))
    (entry,) = os.listdir(cache)
    assert entry.startswith(f"{mod.__name__}.gen-")
    edited = _module(tmp_path / "gen2.py", body.replace("np.ones(n)", "np.zeros(n)"))
    edited.gen.__module__ = mod.__name__  # the same module and name, another source
    assert np.array_equal(disk_cache.cached_arrays(edited.gen, 5)[1], np.zeros(5))
    assert edited.CALLS == [5] and len(os.listdir(cache)) == 2
    monkeypatch.setenv("PT_HOST_CACHE", "0")
    disk_cache.cached_arrays(mod.gen, 5)
    assert mod.CALLS == [5, 5] and len(os.listdir(cache)) == 2
    default = disk_cache._DEFAULT_DIR
    assert not os.path.isdir(default) or not any(e.startswith(mod.__name__) for e in os.listdir(default))


def test_cached_arrays_keys_on_helpers_and_cleans_up(tmp_path, monkeypatch):
    """Editing only a helper in the generator's file misses; a write that
    cannot be published (another process published the entry first) still
    returns the arrays and leaves no temporary directory behind."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("PT_HOST_CACHE", str(cache))
    body = ("import numpy as np\nCALLS = []\ndef _half(n):\n    return np.ones(n)\n"
            "def gen(n):\n    CALLS.append(n)\n    return np.arange(n), _half(n)\n")
    mod = _module(tmp_path / "gen.py", body)
    disk_cache.cached_arrays(mod.gen, 4)
    edited = _module(tmp_path / "gen2.py", body.replace("np.ones(n)", "np.zeros(n)"))
    edited.gen.__module__ = mod.__name__  # the same module and function, another helper
    assert np.array_equal(disk_cache.cached_arrays(edited.gen, 4)[1], np.zeros(4))
    assert edited.CALLS == [4] and len(os.listdir(cache)) == 2

    def taken(src, dst):
        raise OSError(39, "Directory not empty", dst)

    monkeypatch.setattr(disk_cache.os, "replace", taken)
    a, b = disk_cache.cached_arrays(mod.gen, 6)
    assert np.array_equal(a, np.arange(6)) and np.array_equal(b, np.ones(6))
    assert mod.CALLS == [4, 6] and len(os.listdir(cache)) == 2
    assert not any(".tmp" in e for e in os.listdir(cache))


def test_render_config_matches_jax():
    got, want = tconfig.RenderConfig(), jconfig.RenderConfig()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.aspect_ratio == want.aspect_ratio


def test_timers_match_jax(monkeypatch):
    clock = iter([0.0, 1.5, 2.0, 2.25] * 2)
    for mod in (profiling, jprof):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
    out = []
    for mod in (profiling, jprof):
        t, m = mod.PhaseTimer(), mod.RayRateMeter()
        with t.phase("build"):
            pass
        with m.measure(5e5, 2):
            pass
        out.append((t.phases, t.report(), m.mrays_per_s, m.spp_per_s))
    assert out[0] == out[1] == ({"build": 1.5}, "phase timings:\n  build: 1.500s", 2.0, 8.0)
