"""The port's interactive frame (``path_tracer_tpu_torch/interactive``)
against the JAX package's, case by case as ``tests/test_interactive.py``,
plus each TAA stage against its JAX function on the same numpy-seeded
inputs and a 3-frame session against the JAX session.

Tolerances: the float TAA stages within rtol 1e-5, atol 1e-6 (separate
roundings against XLA's fused ones; atol for the values that cancel to near
0); ids and letterbox indices bit-exact (int64 holding the JAX uint32
bits); ``display_frame_u8`` equal on at least 99.9% of values and never more
than 1 apart (a tonemapped value within an ulp of a .5 step may round the
other way). Segmented renders are held to the same bits as ``render_sample``.
The session against JAX: the slice check of ``tests/test_torch_render.py``
on the accumulation (at least 95% of pixels within rtol 1e-3, atol 1e-4,
means within 1%) and ids equal on at least 99% of pixels.
"""

import io
import threading
import urllib.request
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from path_tracer_tpu import scenes as jscenes
from path_tracer_tpu.interactive import session as jsession
from path_tracer_tpu.interactive import taa as jtaa
from path_tracer_tpu_torch import scenes
from path_tracer_tpu_torch.camera import ray_directions
from path_tracer_tpu_torch.integrator import wavefront
from path_tracer_tpu_torch.interactive import session as session_mod
from path_tracer_tpu_torch.interactive import taa
from path_tracer_tpu_torch.interactive.session import InteractiveRenderer
from path_tracer_tpu_torch.interactive.stream import make_server
from torch_builders import numpy_builders  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

H = W = 16
RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(16, 16), (16, 24)]  # (H, W): square, and non-square to catch a swapped axis


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _renderer(name, w, h, max_bounces=4, **kw):
    scene_host, cam = getattr(scenes, name)(aspect=w / h, **kw)
    return InteractiveRenderer(scene_host, cam, w, h, max_bounces=max_bounces, device="cpu")


# --- the cases of tests/test_interactive.py ---


def test_accumulate_layout():
    acc = torch.zeros((H, W, 4))
    colour = torch.ones((H, W, 4)) * 2.0
    out = taa.accumulate(acc, colour)
    np.testing.assert_allclose(out[..., :3].numpy(), 2.0)
    np.testing.assert_allclose(out[..., 3].numpy(), 1.0)  # count, not colour alpha
    out2 = taa.accumulate(out, colour)
    np.testing.assert_allclose(out2[..., 3].numpy(), 2.0)


def test_velocity_zero_for_static_camera():
    cam = scenes.cornell_camera()
    ys = (np.arange(H) + 0.5) / H
    xs = (np.arange(W) + 0.5) / W
    u, v = np.meshgrid(xs, ys, indexing="xy")
    d = ray_directions(_t(cam.view_proj_inverse()), _t(cam.origin),
                       _t(u.ravel().astype(np.float32)), _t(v.ravel().astype(np.float32))).numpy()
    t = 800.0
    world = cam.origin[None] + d * t
    pos = np.concatenate([world, np.full((H * W, 1), t, np.float32)], axis=-1).reshape(H, W, 4)
    vel = taa.compute_velocity(_t(pos), _t(cam.world_to_clip())).numpy()
    assert np.abs(vel).max() < 1e-3


def test_clip_aabb_inside_unchanged():
    lo, hi = torch.tensor([[0.0, 0.0, 0.0]]), torch.tensor([[1.0, 1.0, 1.0]])
    np.testing.assert_allclose(taa._clip_aabb(lo, hi, torch.tensor([[0.5, 0.5, 0.5]])).numpy(), 0.5)
    out2 = taa._clip_aabb(lo, hi, torch.tensor([[2.0, 0.5, 0.5]])).numpy()
    assert 0.0 <= out2[0, 0] <= 1.001  # clipped toward the centre


def test_ycocg_roundtrip():
    rgb = _t(np.random.default_rng(1).uniform(0, 1, (64, 3)).astype(np.float32))
    back = taa._ycocg_to_rgb(taa._rgb_to_ycocg(rgb))
    np.testing.assert_allclose(back.numpy(), rgb.numpy(), atol=1e-6)


def test_interactive_session_static_then_move():
    r = _renderer("cornell_diffuse", W, H)
    r.frame()
    r.frame()
    assert float(r.accumulation[..., 3].max()) == 2.0
    frame_static = r.display()
    assert frame_static.shape == (H, W, 3)
    assert np.isfinite(frame_static).all()
    # a camera move takes the TAA path, which restarts the sample count
    r.key("w", dt=1e-4)
    r.frame()
    assert float(r.accumulation[..., 3].max()) == 1.0
    frame_moved = r.display()
    assert np.isfinite(frame_moved).all()
    assert np.abs(frame_moved - frame_static).max() > 1e-4


def test_pack_ids():
    packed = taa.pack_ids(torch.tensor([[0x00AB]]), torch.tensor([[0x00CD]]))
    assert int(packed[0, 0]) == (0xAB << 16) | 0xCD
    # the uint32 shift drops the high bits
    packed = taa.pack_ids(torch.tensor([[0xABCD1234]]), torch.tensor([[0xFFFF5678]]))
    assert int(packed[0, 0]) == 0x12345678


def test_display_letterboxed():
    frame = torch.ones((9, 16, 3))  # 16:9 content
    out = taa.display_letterboxed(frame, 20, 20).numpy()  # square window
    assert out.shape == (20, 20, 3)
    assert out[0].max() == 0.0 and out[-1].max() == 0.0  # bars top and bottom
    assert out[10].max() == 1.0
    assert out[:, 0].max() == 1.0 or out[:, 1].max() == 1.0


def _png_shape(data: bytes):
    """(height, width, rgb rows) of a PNG from `imageio.encode_png` (8-bit
    RGB, filter 0 on every row)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    idat = data.index(b"IDAT")
    n = int.from_bytes(data[idat - 4:idat], "big")
    raw = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]), np.uint8)
    return h, w, raw.reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)


def test_http_live_view_stream_and_input():
    """The live view over loopback: JPEG parts of the stream (Pillow's
    decode of the last equal to Pillow's quality-88 round trip of the
    frame, as the JAX package sends it), key, mouse and resize input, a PNG
    still."""
    r = _renderer("cornell_diffuse", 32, 32)
    srv = make_server(r, "127.0.0.1", 0, max_frames=2)  # ephemeral port
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        assert b"/stream" in urllib.request.urlopen(f"{base}/", timeout=30).read()
        yaw0 = r.camera.yaw
        urllib.request.urlopen(f"{base}/mouse?dx=0&dy=2e-4&dt=0.0167", timeout=30).read()
        assert r.camera.yaw != yaw0
        origin0 = r.camera.origin.copy()
        urllib.request.urlopen(f"{base}/key?k=w&dt=1e-6", timeout=30).read()
        assert not np.array_equal(r.camera.origin, origin0)
        raw = urllib.request.urlopen(f"{base}/stream", timeout=300).read()
        parts = [p for p in raw.split(b"--frame") if b"Content-Type: image/jpeg" in p]
        assert len(parts) == 2
        jpg = parts[-1].split(b"\r\n\r\n", 1)[1].rstrip(b"\r\n")
        rgb = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
        assert rgb.shape == (32, 32, 3)
        assert r.sample >= 2  # the stream drove the render loop
        buf = io.BytesIO()
        Image.fromarray(r.display(as_uint8=True), "RGB").save(buf, "JPEG", quality=88)
        np.testing.assert_array_equal(rgb, np.asarray(Image.open(buf).convert("RGB")))
        urllib.request.urlopen(f"{base}/resize?w=24&h=16", timeout=30).read()
        assert (r.width, r.height, r.sample) == (24, 16, 0)
        h, w, _ = _png_shape(urllib.request.urlopen(f"{base}/frame.png", timeout=60).read())
        assert (h, w) == (16, 24)
    finally:
        srv.shutdown()
        srv.server_close()


def test_resize_reconfigures_surface():
    r = _renderer("cornell_diffuse", 32, 32)
    r.frame()
    assert r.sample == 1
    proj_before = r.camera.projection.copy()
    r.resize(48, 24)
    assert r.accumulation.shape == (24, 48, 4)
    assert r.ids.shape == (24, 48)
    assert r.sample == 0
    assert not np.allclose(r.camera.projection, proj_before)  # new aspect
    r.frame()
    img = r.display()
    assert img.shape == (24, 48, 3)
    assert np.isfinite(img).all()
    r.resize(48, 24)  # no-op resize keeps history
    assert r.sample == 1


def test_frame_path_flows_through_the_entry(monkeypatch):
    """The port of ``test_frame_path_compiles_once``: eager torch compiles
    nothing, so what stays is that every frame goes through the session's
    `render_sample_segmented` (or `render_sample`) entry, which is
    wavefront's, and the frames stay finite."""
    name = "render_sample_segmented" if session_mod._SEGMENTED else "render_sample"
    real_entry = getattr(session_mod, name)
    assert real_entry is getattr(wavefront, name)
    calls = []

    def counting_entry(*a, **kw):
        calls.append(1)
        return real_entry(*a, **kw)

    monkeypatch.setattr(session_mod, name, counting_entry)
    r = _renderer("cornell_diffuse", 32, 18)
    for i in range(4):
        if i % 2 == 0:
            r.mouse(-1e-4, 2e-4, 1.0 / 60.0)
            r.key("w", 6e-6)
        r.frame()
        img = r.display()
    assert len(calls) == 4
    assert np.isfinite(img).all()


def _small_schedule(monkeypatch):
    """Segment lengths and the size menu forced tiny, so that several
    segments, several shrink levels and the tail steps run (the default
    menu floors at 2048 lanes)."""
    monkeypatch.setattr(wavefront, "_SEG_B0", 2)
    monkeypatch.setattr(wavefront, "_SEG_STEPS", 2)
    monkeypatch.setattr(wavefront, "_seg_caps", lambda n: [(3 * n) // 4, n // 2, n // 4])
    monkeypatch.setattr(wavefront, "_SEG_TAIL_AT", (24 * 16) // 4)
    monkeypatch.setattr(wavefront, "_SEG_TAIL_STEPS", 5)


def _scene_args(name, w, h, max_bounces=12):
    sh, cam = getattr(scenes, name)(aspect=w / h)
    scene = sh.device("cpu")
    kw = dict(max_bounces=max_bounces, has_lights="light" in scene, mtypes=sh.active_mtypes,
              any_volumes=sh.has_volumes)
    return scene, _t(cam.view_proj_inverse()), _t(cam.origin), kw, cam


@pytest.mark.parametrize("scene_name", ["cornell_diffuse", "cornell_specular", "cornell_volume"])
def test_segmented_matches_monolithic(monkeypatch, scene_name):
    """`render_sample_segmented` gives `render_sample`'s bits on every
    output (radiance, position, first id, ray counts); on cornell_volume
    compaction must carry each lane's ``vol_stack``."""
    _small_schedule(monkeypatch)
    w, h = 24, 16
    scene, ndc, org, kw, _ = _scene_args(scene_name, w, h)
    for sample_id in (0, 3):
        ref = wavefront.render_sample(scene, ndc, org, sample_id, w, h, **kw)
        got = wavefront.render_sample_segmented(scene, ndc, org, sample_id, w, h, **kw)
        for r_, g_, nm in zip(ref, got, ("rad", "pos", "id", "rays")):
            assert torch.equal(r_, g_), f"{scene_name} sample {sample_id}: {nm} differs"


def test_seg_key_covers_resize_and_focus(monkeypatch):
    """The port of ``test_seg_warm_key_covers_resize_and_focus``: the
    predictor's key differs across a resize, a transposed resize (the same
    lane count) and a focus change, so a plan is never reused for another
    configuration; each segmented render equals its monolithic twin."""
    monkeypatch.setattr(wavefront, "_SEG_B0", 2)
    monkeypatch.setattr(wavefront, "_SEG_STEPS", 3)
    monkeypatch.setattr(wavefront, "_seg_caps", lambda n: [n // 2])
    sh, cam = scenes.cornell_diffuse(aspect=1.0)
    scene = sh.device("cpu")
    kw = dict(max_bounces=6, has_lights=True, mtypes=sh.active_mtypes, any_volumes=sh.has_volumes)
    ndc, org = _t(cam.view_proj_inverse()), _t(cam.origin)
    basis = _t(cam.matrix[:, :3])
    configs = [
        dict(width=24, height=16),
        dict(width=16, height=24),  # transposed: the same lane count
        dict(width=24, height=16, aperture=8.0, focus=400.0, cam_basis=basis),
        dict(width=24, height=16, aperture=8.0, focus=800.0, cam_basis=basis),
    ]
    keys = set()
    for cfg in configs:
        pred = wavefront.SegmentPredictor()
        seg = wavefront.render_sample_segmented(scene, ndc, org, 0, predictor=pred, **cfg, **kw)
        mono = wavefront.render_sample(scene, ndc, org, 0, **cfg, **kw)
        for s_, m_ in zip(seg, mono):
            assert torch.equal(s_, m_)
        keys.add(pred.key)
    assert len(keys) == len(configs), "each configuration must key its own plan"


# --- each TAA stage against the JAX function ---


def _taa_inputs(h, w):
    rs = np.random.default_rng(7 + h * 31 + w)
    colour = np.concatenate([rs.uniform(0, 2, (h, w, 3)), rs.uniform(0.5, 2, (h, w, 1))], -1)
    acc = np.concatenate([rs.uniform(0, 8, (h, w, 3)), rs.integers(1, 9, (h, w, 1))], -1)
    cam = scenes.cornell_camera(aspect=w / h)
    pos = np.concatenate([rs.uniform(-300, 300, (h, w, 2)), rs.uniform(-800, 300, (h, w, 1)),
                          rs.uniform(1, 900, (h, w, 1))], -1)
    aabb_lo = rs.uniform(-1, 0, (h, w, 3))
    aabb_hi = aabb_lo + rs.uniform(0, 1, (h, w, 3)) * (rs.uniform(size=(h, w, 1)) > 0.1)
    return {
        "colour": colour.astype(np.float32),
        "acc": acc.astype(np.float32),
        "velocity": rs.uniform(-0.2, 0.2, (h, w, 2)).astype(np.float32),
        "ids": (rs.integers(0, 4, (h, w)) << 16 | rs.integers(0, 4, (h, w))).astype(np.uint32),
        "prev_ids": rs.integers(0, 2**32, (h, w), dtype=np.uint64).astype(np.uint32),
        "new_id": rs.integers(0, 2**32, (h, w), dtype=np.uint64).astype(np.uint32),
        "position": pos.astype(np.float32),
        "wtc": cam.world_to_clip(),
        "uv": rs.uniform(-0.1, 1.1, (h, w, 2)).astype(np.float32),
        "lo": aabb_lo.astype(np.float32),
        "hi": aabb_hi.astype(np.float32),
        "q": rs.uniform(-2, 2, (h, w, 3)).astype(np.float32),
    }


def _both(x):
    """(JAX input, torch input): uint32 ids become int64 on the torch side."""
    if x.dtype == np.uint32:
        return jnp.asarray(x), _t(x.astype(np.int64))
    return jnp.asarray(x), _t(x)


STAGES = {
    "accumulate": (("acc", "colour"), "accumulate", "accumulate"),
    "w_divide": (("acc",), "w_divide", "w_divide"),
    "compute_velocity": (("position", "wtc"), "compute_velocity", "compute_velocity"),
    "rgb_to_ycocg": (("q",), "_rgb_to_ycocg", "_rgb_to_ycocg"),
    "ycocg_to_rgb": (("q",), "_ycocg_to_rgb", "_ycocg_to_rgb"),
    "clip_aabb": (("lo", "hi", "q"), "_clip_aabb", "_clip_aabb"),
    "bilinear": (("acc", "uv"), "_bilinear", "_bilinear"),
    "catmull_rom": (("acc", "uv"), "_sample_catmull_rom", "_sample_catmull_rom"),
    "temporal_reproject": (("colour", "acc", "velocity", "ids"), "temporal_reproject",
                           "temporal_reproject"),
    "display_frame": (("acc",), "display_frame", "display_frame"),
    "pack_ids": (("prev_ids", "new_id"), "pack_ids", "pack_ids"),
    "frame_update_static": (("prev_ids", "acc", "colour", "new_id"), "frame_update_static",
                            "frame_update_static"),
    "frame_update_moving": (("prev_ids", "acc", "colour", "new_id", "position", "wtc"),
                            "frame_update_moving", "frame_update_moving"),
}


def _assert_stage(name, j, t):
    j = np.asarray(j)
    t = t.numpy()
    if np.issubdtype(j.dtype, np.integer):
        np.testing.assert_array_equal(t, j.astype(np.int64), err_msg=name)
    else:
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES, ids=["16x16", "24x16"])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_taa_stage_matches_jax(stage, shape):
    args, jname, tname = STAGES[stage]
    inp = _taa_inputs(*shape)
    pairs = [_both(inp[a]) for a in args]
    j = getattr(jtaa, jname)(*[p[0] for p in pairs])
    t = getattr(taa, tname)(*[p[1] for p in pairs])
    if isinstance(j, tuple):
        for k, (jj, tt) in enumerate(zip(j, t)):
            _assert_stage(f"{stage}[{k}]", jj, tt)
    else:
        _assert_stage(stage, j, t)


@pytest.mark.parametrize("shape", SHAPES, ids=["16x16", "24x16"])
def test_display_u8_and_letterbox_match_jax(shape):
    inp = _taa_inputs(*shape)
    j = np.asarray(jtaa.display_frame_u8(jnp.asarray(inp["acc"]))).astype(np.int64)
    t = taa.display_frame_u8(_t(inp["acc"])).numpy().astype(np.int64)
    assert (t == j).mean() >= 0.999 and np.abs(t - j).max() <= 1
    frame = np.random.default_rng(3).uniform(0, 1, (*shape, 3)).astype(np.float32)
    for out_h, out_w in ((20, 20), (9, 40), (33, 17)):
        jl = np.asarray(jtaa.display_letterboxed(jnp.asarray(frame), out_h, out_w))
        tl = taa.display_letterboxed(_t(frame), out_h, out_w).numpy()
        np.testing.assert_array_equal(tl, jl)


def test_session_matches_jax(monkeypatch):
    """Three frames of one session on cornell_diffuse at 16x16, 4 bounces,
    in both packages: static, static, then moved (the TAA path). The JAX
    session takes its monolithic frame (bit-equal to its segmented one,
    ``tests/test_interactive.py``; it compiles once), the port its
    segmented default."""
    monkeypatch.setattr(jsession, "_SEGMENTED", False)
    jsh, jcam = jscenes.cornell_diffuse()
    jr = jsession.InteractiveRenderer(jsh, jcam, W, H, max_bounces=4)
    tr = _renderer("cornell_diffuse", W, H)
    assert session_mod._SEGMENTED
    for i in range(3):
        if i == 2:
            for r in (jr, tr):
                r.mouse(2e-4, 1e-4, 1.0 / 60.0)
                r.key("w", 6e-6)
        jr.frame()
        tr.frame()
        ja, ta = np.asarray(jr.accumulation), tr.accumulation.numpy()
        close = np.isclose(ta, ja, rtol=1e-3, atol=1e-4).all(axis=-1)
        assert close.mean() >= 0.95, (i, close.mean())
        assert abs(ta[..., :3].mean() - ja[..., :3].mean()) <= 0.01 * ja[..., :3].mean()
        np.testing.assert_array_equal(ta[..., 3], ja[..., 3])
        assert (tr.ids.numpy() == np.asarray(jr.ids).astype(np.int64)).mean() >= 0.99
    jd, td = jr.display(), tr.display()
    assert np.isclose(td, jd, rtol=1e-3, atol=1e-4).all(axis=-1).mean() >= 0.95


def test_session_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sh, cam = scenes.cornell_diffuse()
    with pytest.raises(RuntimeError, match="cuda"):
        InteractiveRenderer(sh, cam, W, H)
