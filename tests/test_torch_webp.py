"""The port's WebP codec (``path_tracer_tpu_torch/utils/{webp,vp8,vp8l}.py``)
against the JAX package's Pillow loader and writer.

Reading: ``envmap.load_image`` equals the JAX package's bit for bit on
lossy files (qualities 0-100, methods 0-6, odd sizes), lossless ones
(methods, qualities, 2- to 256-colour palettes for pixel bundling, gray,
RGBA with ``exact``), ``VP8X`` with ``ALPH`` (alpha qualities 100 and 50),
Pillow's two-frame animation, a hand-built animation whose frame 0 is
offset and smaller than the canvas, and the port's own encoder writing 4
and 8 partitions, the simple filter and 4 segments (Pillow's decode the
reference). Container faults raise ``ValueError`` where Pillow raises.
Writing: ``.webp`` meets the writer's criteria against Pillow's
quality-80 file on three images (Pillow opens it, both decodes equal, PSNR
at most 1 dB below, size at most 1.5x, the same chunk layout), through
``save_image``, ``film.save_png`` and ``--out``. Each native loop equals
its Python twin, corrupt files raise only ``ValueError``, the committed
digests equal Pillow's, and the WebP-sky scene's host tables equal the
JAX package's load of it.

``PYTHONPATH=. python tests/test_torch_webp.py`` rewrites the WebP assets
(``assets/sky.webp``, ``assets/format_*.webp``, ``assets/
asset_scene_webp.json``) and ``assets/webp_digests.json``, the SHA-256 of
Pillow's ``convert("RGB")`` bytes of each, which ``chip_smoke.py`` holds
the port's decoder to on the card's machine (no Pillow there).
"""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_inputs import _assert_scenes_equal

from path_tracer_tpu import native as jnative
from path_tracer_tpu.scene import envmap as jenv
from path_tracer_tpu.utils import config as jconfig
from path_tracer_tpu_torch import cli, native
from path_tracer_tpu_torch.film import film as tfilm
from path_tracer_tpu_torch.scene import envmap as tenv
from path_tracer_tpu_torch.utils import config as tconfig
from path_tracer_tpu_torch.utils import imageio, vp8, vp8l, webp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGESTS = "assets/webp_digests.json"
WEBP_SCENE = "assets/asset_scene_webp.json"


# --- file builders ---


def pixels(h, w, seed, channels=3):
    """A smooth pattern with noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5 + c) * np.cos(y / 4 - c) for c in range(channels)], -1)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)


def pillow(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "WEBP", **kw)
    return buf.getvalue()


def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def riff(*chunks: bytes) -> bytes:
    body = b"".join(chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def chunks_of(data: bytes, start=12, end=None) -> list:
    out, pos, end = [], start, len(data) if end is None else end
    while pos < end:
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))


def animation(canvas, frame: bytes, at) -> bytes:
    """A one-frame animation: ``frame`` (a still WebP file) at ``at`` (even
    x, y) on a ``canvas`` (w, h)."""
    inner = b"".join(chunk(t, p) for t, p in chunks_of(frame) if t in (b"ALPH", b"VP8 ", b"VP8L"))
    w, h = (vp8l.header if chunks_of(frame)[-1][0] == b"VP8L" else lambda p: vp8.header(p)[:2])(
        chunks_of(frame)[-1][1])
    anmf = b"".join(v.to_bytes(3, "little") for v in (at[0] // 2, at[1] // 2, w - 1, h - 1, 100)) + b"\0" + inner
    return riff(vp8x(0x02, *canvas), chunk(b"ANIM", bytes(6)), chunk(b"ANMF", anmf))


def with_alpha(rgb: np.ndarray) -> np.ndarray:
    h, w, _ = rgb.shape
    a = ((np.arange(w)[None] * 255 // max(w - 1, 1) + np.arange(h)[:, None] * 3) % 256).astype(np.uint8)
    return np.concatenate([rgb, a[..., None]], axis=-1)


# --- the committed assets ---


def asset_files() -> dict:
    """``{repo path: bytes}`` of phase 26's WebP assets, made from
    ``assets/sky.png`` (512x256) with Pillow."""
    sky = np.asarray(Image.open(os.path.join(REPO, "assets", "sky.png")).convert("RGB"))
    crop = sky[64:160, 128:320]
    scene = json.loads(open(os.path.join(REPO, "assets", "asset_scene.json")).read())
    scene["env"] = "assets/sky.webp"
    return {
        "assets/sky.webp": pillow(Image.fromarray(sky), lossless=True),
        "assets/format_sky_q80.webp": pillow(Image.fromarray(sky), quality=80),
        "assets/format_sky_alpha.webp": pillow(Image.fromarray(with_alpha(sky), "RGBA"), quality=80),
        "assets/format_anim.webp": animation((512, 256), pillow(Image.fromarray(crop), quality=90), (100, 52)),
        WEBP_SCENE: (json.dumps(scene, indent=2) + "\n").encode(),
    }


def write_assets() -> None:
    """Write the assets and the digests of the images (Pillow's decode)."""
    digests = {}
    for rel, data in asset_files().items():
        with open(os.path.join(REPO, rel), "wb") as f:
            f.write(data)
        if rel.endswith(".webp"):
            rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            digests[rel] = {"shape": list(rgb.shape), "bytes": len(data),
                            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    with open(os.path.join(REPO, DIGESTS), "w") as f:
        f.write(json.dumps(digests, indent=1) + "\n")


# --- reading ---

RGB = pixels(29, 45, 1)
SKY = np.asarray(Image.open(os.path.join(REPO, "assets", "sky.png")).convert("RGB"))
READ_CASES = {
    **{f"lossy_q{q}_m{m}": (lambda q=q, m=m: pillow(Image.fromarray(RGB), quality=q, method=m))
       for q in (0, 50, 80, 100) for m in (0, 4, 6)},
    "lossy_1x1": lambda: pillow(Image.fromarray(RGB[:1, :1])),
    "lossy_17x33": lambda: pillow(Image.fromarray(pixels(17, 33, 2))),
    "lossy_50x20": lambda: pillow(Image.fromarray(pixels(20, 50, 3))),
    **{f"lossless_m{m}_q{q}": (lambda q=q, m=m: pillow(Image.fromarray(RGB), lossless=True, method=m, quality=q))
       for m in (0, 6) for q in (0, 100)},
    **{f"lossless_palette{k}": (lambda k=k: pillow(Image.fromarray(RGB).quantize(k).convert("RGB"), lossless=True))
       for k in (2, 4, 16, 256)},
    "lossless_gray": lambda: pillow(Image.fromarray(RGB[..., 0]).convert("RGB"), lossless=True),
    "lossy_alpha100": lambda: pillow(Image.fromarray(with_alpha(RGB), "RGBA"), alpha_quality=100),
    "lossy_alpha50": lambda: pillow(Image.fromarray(with_alpha(RGB), "RGBA"), alpha_quality=50),
    "lossless_rgba_exact": lambda: pillow(Image.fromarray(with_alpha(RGB), "RGBA"), lossless=True, exact=True),
    "anim_pillow_2_frames": lambda: pillow(Image.fromarray(RGB), save_all=True, duration=50,
                                           append_images=[Image.fromarray(RGB[::-1].copy())]),
    "anim_frame0_offset": lambda: animation((64, 48), pillow(Image.fromarray(pixels(20, 30, 4)), quality=70), (10, 8)),
    "port_partitions4": lambda: webp.encode_webp(SKY[:48, :80], partitions=4),
    "port_partitions8_simple": lambda: webp.encode_webp(SKY[100:164, :48], partitions=8, simple=True),
    "port_segments4": lambda: webp.encode_webp(pixels(40, 56, 5), segments=4),
}


@pytest.mark.parametrize("case", list(READ_CASES))
def test_load_matches_jax(tmp_path, case):
    """``envmap.load_image`` equals the JAX package's (Pillow) bit for bit;
    the port's uint8 decode equals Pillow's ``convert("RGB")``."""
    path = tmp_path / f"{case}.webp"
    path.write_bytes(READ_CASES[case]())
    np.testing.assert_array_equal(tenv.load_image(path), jenv.load_image(path))
    np.testing.assert_array_equal(imageio.decode_image(path.read_bytes(), str(path)),
                                  np.asarray(Image.open(path).convert("RGB")))


def _frame() -> bytes:
    return pillow(Image.fromarray(pixels(20, 30, 6)))


CONTAINER_FAULTS = {  # each raises in Pillow too
    "truncated": lambda: _frame()[:-10],
    "chunk_past_end": lambda: _frame()[:12] + b"VP8 " + struct.pack("<I", 10 ** 6) + _frame()[20:],
    "canvas_size_differs": lambda: riff(vp8x(0, 31, 20), chunk(*chunks_of(_frame())[0])),
    "unknown_vp8x_flag": lambda: riff(vp8x(0x01, 30, 20), chunk(*chunks_of(_frame())[0])),
    "frame_outside_canvas": lambda: animation((40, 30), _frame(), (20, 20)),
    "alph_before_vp8l": lambda: riff(vp8x(0x10, 30, 20), chunk(b"ALPH", bytes(601)),
                                     chunk(*chunks_of(pillow(Image.fromarray(pixels(20, 30, 6)), lossless=True))[0])),
    "alph_plane_short": lambda: riff(vp8x(0x10, 30, 20), chunk(b"ALPH", bytes(501)), chunk(*chunks_of(_frame())[0])),
    "anmf_without_flag": lambda: riff(vp8x(0, 40, 30), *[chunk(t, p) for t, p in
                                                          chunks_of(animation((40, 30), _frame(), (6, 4)))[1:]]),
}


@pytest.mark.parametrize("case", list(CONTAINER_FAULTS))
def test_container_faults_raise(tmp_path, case):
    """libwebp's demuxer checks: where Pillow cannot open the file, the port
    raises ``ValueError`` naming it."""
    path = tmp_path / f"{case}.webp"
    path.write_bytes(CONTAINER_FAULTS[case]())
    with pytest.raises(OSError):
        Image.open(path).convert("RGB")
    with pytest.raises(ValueError) as err:
        tenv.load_image(path)
    assert str(path) in str(err.value)


# --- writing ---


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    return float(10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2)))


@pytest.mark.parametrize("image", ["assets/sky.png", "renders/asset_scene_cpu.png", "renders/mesh_scene.png"])
def test_writer_criteria(image):
    """The port's ``.webp`` against Pillow's quality-80 file of the same
    pixels: Pillow opens it and decodes it to the port's decode; PSNR at
    most 1.0 dB below Pillow's file's; size at most 1.5x; the same chunk
    layout (``RIFF``/``WEBP``/``VP8 `` only)."""
    px = np.asarray(Image.open(os.path.join(REPO, image)).convert("RGB"))
    ours, ref = webp.encode_webp(px), pillow(Image.fromarray(px))
    got = np.asarray(Image.open(io.BytesIO(ours)).convert("RGB"))
    np.testing.assert_array_equal(webp.decode_webp(ours), got)
    want = np.asarray(Image.open(io.BytesIO(ref)).convert("RGB"))
    assert psnr(got, px) >= psnr(want, px) - 1.0
    assert len(ours) <= 1.5 * len(ref)
    assert [t for t, _ in chunks_of(ours)] == [t for t, _ in chunks_of(ref)] == [b"VP8 "]


@pytest.mark.parametrize("path", ["save_image", "save_png", "cli_out"])
def test_webp_outputs(tmp_path, path):
    """``envmap.save_image``, ``film.save_png`` and ``--out x.webp`` write the
    port's WebP of the 8-bit pixels, in the layout of the JAX package's
    file, which Pillow reads to the port's decode."""
    out = tmp_path / "t.webp"
    if path == "cli_out":
        res = cli.main(["--scene", "env_sphere_scene", "--width", "8", "--height", "8", "--spp", "1",
                        "--max-bounces", "2", "--device", "cpu", "--out", str(out)])
        rgb8 = np.clip(tfilm.film_to_srgb(res["film"]).numpy() * 255.0, 0, 255).astype(np.uint8)[::-1]
        jenv.save_image(tmp_path / "j.webp", rgb8 / 255.0)
    elif path == "save_png":
        film = torch.from_numpy(np.random.default_rng(7).uniform(0, 4, (24, 40, 4)).astype(np.float32))
        tfilm.save_png(out, film)
        rgb8 = np.clip(tfilm.film_to_srgb(film).numpy() * 255.0, 0, 255).astype(np.uint8)[::-1]
        jenv.save_image(tmp_path / "j.webp", rgb8 / 255.0)
    else:
        img = np.random.default_rng(8).uniform(-0.1, 1.1, (24, 40, 3)).astype(np.float32)
        tenv.save_image(out, img)
        jenv.save_image(tmp_path / "j.webp", img)
        rgb8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    data = out.read_bytes()
    assert data == webp.encode_webp(np.ascontiguousarray(rgb8))
    assert [t for t, _ in chunks_of(data)] == [t for t, _ in chunks_of((tmp_path / "j.webp").read_bytes())]
    np.testing.assert_array_equal(np.asarray(Image.open(out).convert("RGB")), imageio.decode_image(data))


# --- native against the Python twins ---


@pytest.fixture(scope="module")
def native_cases() -> dict:
    """The native-loop cases' inputs, made once for the module."""
    img = pixels(40, 56, 9)
    lossless = {k: chunks_of(pillow(Image.fromarray(img if k != "palette" else img // 64 * 64), lossless=True,
                                    method=m))[0][1] for k, m in (("m0", 0), ("m6", 6), ("palette", 4))}
    lossy = {k: pillow(Image.fromarray(img), quality=q) for k, q in (("q10", 10), ("q90", 90))}
    lossy["port_p8_simple_s4"] = webp.encode_webp(img, partitions=8, simple=True, segments=4)
    yuv = vp8.rgb_to_yuv(img)
    segs = (np.arange(12) % 4).astype(np.int32)
    quant = np.array([vp8._quant_steps(q, (0, 0, 0, -2, 0)) for q in (10, 19, 30, 60)], np.int32)
    lambdas = np.array([(vp8.LAMBDA * int(vp8.AC_TABLE[q]) ** 2) >> 4 for q in (10, 19, 30, 60)], np.int64)
    return {"lossless": lossless, "lossy": lossy, "enc": (yuv, segs, quant, lambdas)}


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.shape == b.shape and bool((a == b).all())
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("loop", ["vp8l_decode", "vp8_decode_frame", "vp8_encode_mbs", "vp8_write_tokens",
                                  "vp8_write_modes"])
def test_native_matches_python(native_cases, loop):
    """Each native WebP loop equals its Python twin (lossless files at
    methods 0, 4 and 6 with a palette; lossy ones at qualities 10 and 90 and
    the port's 8-partition, simple-filter, 4-segment frame; the encoder on
    four segments' quantizers)."""
    if native._load() is None:
        pytest.skip("no g++: the native library is not built")
    cases = native_cases
    if loop == "vp8l_decode":
        for payload in cases["lossless"].values():
            w, h = vp8l.header(payload)
            assert _equal(native.vp8l_decode(payload, w, h, 40, vp8l.DISTANCE_MAP),
                          vp8l._decode_stream_py(payload, w, h, 40))
        return
    if loop == "vp8_decode_frame":
        for data in cases["lossy"].values():
            payload = chunks_of(data)[0][1]
            w, h, br, parts, P = vp8._parse_header(payload)
            mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
            got = native.vp8_decode_frame(payload[10:10 + len(br.data)], br.state(), parts, mb_w, mb_h, P,
                                        vp8.BMODES_PROBA)
            want = vp8._decode_frame_py(br, [vp8._BoolDecoder(p) for p in parts], mb_w, mb_h,
                                        dict(P, probs=P["probs"].tolist()))
            assert _equal(got, want)
        return
    (Y, U, V), segs, quant, lambdas = cases["enc"]
    Y, U, V = Y[:32, :48], U[:16, :24], V[:16, :24]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        modes, levels = vp8._encode_mbs(Y, U, V, segs[:6], quant, lambdas)
    if loop == "vp8_encode_mbs":
        got = native.vp8_encode_mbs(Y, U, V, segs[:6], quant, lambdas, (vp8._ROUND_DC, vp8._ROUND_AC),
                                    vp8._COEFF_PROBA0, vp8.BIT_COST, vp8.BMODES_PROBA)
        assert _equal(got, (modes, levels))
        return
    skips = (~levels.reshape(6, -1).any(axis=1)).astype(np.uint8)
    if loop == "vp8_write_tokens":
        for probs in (None, vp8._COEFF_PROBA0):
            for parts in (1, 2):
                assert _equal(native.vp8_write_tokens(modes, levels, skips, probs, 3, parts),
                              vp8._write_tokens_py(modes, levels, skips, probs, 3, parts))
        return
    bits = np.array([(k % 2, 40 + 7 * k) for k in range(30)], np.int32)
    for seg_probs, skip_p in ((None, 0), ([120, 90, 200], 77)):
        assert (native.vp8_write_modes(bits, modes, segs[:6], skips, seg_probs, skip_p, 3, vp8.BMODES_PROBA)
                == vp8._write_modes_py(bits, modes, segs[:6], skips, seg_probs, skip_p, 3))


@pytest.mark.parametrize("family", ["lossy", "lossless", "extended"])
@pytest.mark.parametrize("impl", ["native", "python"])
def test_corrupt_files_raise_value_error(monkeypatch, family, impl):
    """Files with random bytes overwritten or cut short decode to an image
    or raise ``ValueError`` naming the file: no other exception, and no
    read outside the native loops' buffers."""
    if impl == "native" and native._load() is None:
        pytest.skip("no g++: the native library is not built")
    monkeypatch.setattr(native, "available", (lambda: True) if impl == "native" else (lambda: False))
    small = pixels(11, 19, 10)
    files = {
        "lossy": [pillow(Image.fromarray(small)), webp.encode_webp(small, partitions=2, segments=4)],
        "lossless": [pillow(Image.fromarray(small), lossless=True),
                     pillow(Image.fromarray(small // 85 * 85), lossless=True)],
        "extended": [pillow(Image.fromarray(with_alpha(small), "RGBA")),
                     animation((24, 16), pillow(Image.fromarray(small), lossless=True), (2, 4))],
    }[family]
    rng = np.random.default_rng(len(family) + len(impl))
    for i in range(40):
        data = bytearray(files[i % len(files)])
        for j in rng.integers(12, len(data), rng.integers(1, 4)):
            data[j] = rng.integers(0, 256)
        if i % 5 == 0:
            data = data[:rng.integers(2, len(data))]
        try:
            out = imageio.decode_image(bytes(data), "corrupt")
        except ValueError as err:
            assert "corrupt" in str(err)
        else:
            assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3


# --- the committed assets and the WebP-sky scene ---


def test_webp_digests_match_pillow(monkeypatch):
    """``assets/webp_digests.json`` holds the SHA-256 of Pillow's
    ``convert("RGB")`` bytes of each committed WebP file (the card's
    machine, without Pillow, holds the port to them); the port's decode
    matches; the lossless sky is ``sky.png``'s pixels; each file is a few
    KB; the animation's frame 0 is offset on a black canvas."""
    monkeypatch.chdir(REPO)
    digests = json.loads(open(DIGESTS).read())
    assert len(digests) == 4
    for path, d in digests.items():
        data = open(path, "rb").read()
        assert len(data) == d["bytes"] < 12_000
        want = np.asarray(Image.open(path).convert("RGB"))
        assert list(want.shape) == d["shape"]
        assert hashlib.sha256(want.tobytes()).hexdigest() == d["sha256"]
        got = imageio.decode_image(data, path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == d["sha256"], path
    np.testing.assert_array_equal(imageio.decode_image(open("assets/sky.webp", "rb").read()), SKY)
    anim = imageio.decode_image(open("assets/format_anim.webp", "rb").read())
    assert anim.shape == (256, 512, 3) and not anim[:52].any() and anim[52:148, 100:292].any()
    assert json.loads(open(WEBP_SCENE).read())["env"] == "assets/sky.webp"


def test_webp_sky_scene_tables(monkeypatch):
    """``assets/asset_scene_webp.json`` (``asset_scene.json`` under the
    lossless WebP copy of ``sky.png``): host tables equal to the JAX
    package's load of it, sky included (both packages on their NumPy
    builders, as ``tests/torch_builders.py`` explains); it is the PNG-sky
    scene but for the sky's file, and its sky is ``sky.png``'s."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    tsh = tconfig.load_scene_json(WEBP_SCENE)
    assert tsh.num_world_tris == 13832 and tsh.env.shape == (256, 512, 3)
    _assert_scenes_equal(jconfig.load_scene_json(WEBP_SCENE), tsh)
    png = json.loads(open(os.path.join("assets", "asset_scene.json")).read())
    assert dict(png, env="assets/sky.webp") == json.loads(open(WEBP_SCENE).read())
    np.testing.assert_array_equal(np.asarray(tsh.env), tenv.load_image(os.path.join("assets", "sky.png")))


if __name__ == "__main__":
    write_assets()
    for rel, d in json.loads(open(os.path.join(REPO, DIGESTS)).read()).items():
        print(rel, d["shape"], d["bytes"])
