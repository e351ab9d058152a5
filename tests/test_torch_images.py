"""The port's image codecs (``path_tracer_tpu_torch/utils/imageio.py``)
against the JAX package's Pillow loader and writer.

Reading: the port's ``envmap.load_image`` equals the JAX package's bit for
bit on JPEG (baseline 4:4:4 / 4:2:2 / 4:2:0 at several qualities, gray,
progressive, restart intervals, odd sizes) and PNG files (every colour type
at every bit depth, Adam7, a palette with ``tRNS``), all written here; 16-bit
gray PNG is the one divergence (Pillow clips, the port keeps the high
byte), asserted as such. Writing: Pillow's decode of every JPEG the port
writes equals Pillow's decode of the JAX package's file for the same pixels
(``save_image``, ``save_png``, the live view's quality 88). The native
entropy coder and DCTs equal the Python/NumPy ones, the committed JPEG
digests equal Pillow's, and the JPEG-sky JSON scene renders as the JAX
package renders it (``tests/test_torch_render.py``'s slice check).
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_inputs import _assert_scenes_equal, _render_pair

from path_tracer_tpu.film import film as jfilm
from path_tracer_tpu.interactive import stream as jstream
from path_tracer_tpu.scene import envmap as jenv
from path_tracer_tpu.utils import config as jconfig
from path_tracer_tpu_torch import cli, native
from path_tracer_tpu_torch.film import film as tfilm
from path_tracer_tpu_torch.scene import envmap as tenv
from path_tracer_tpu_torch.utils import config as tconfig
from path_tracer_tpu_torch.utils import imageio, webp
from test_torch_render import _assert_slice_agrees
from torch_builders import numpy_builders  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_SCENE = os.path.join("assets", "asset_scene_jpeg.json")  # its paths are relative to the repo


def _pixels(h, w, seed, channels=3):
    """A smooth pattern with noise: blocks with both low and high frequencies."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5 + c) * np.cos(y / 4 - c) for c in range(channels)], -1)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)


# --- JPEG, read ---

JPEG_CASES = {
    **{f"444_q{q}": ((23, 37), dict(quality=q, subsampling=0)) for q in (50, 75, 95, 100)},
    **{f"422_q{q}": ((23, 37), dict(quality=q, subsampling=1)) for q in (50, 75, 95, 100)},
    **{f"420_q{q}": ((23, 37), dict(quality=q, subsampling=2)) for q in (50, 75, 95, 100)},
    "gray": ((23, 37), dict(quality=85, gray=True)),
    "progressive_420": ((23, 37), dict(quality=80, progressive=True)),
    "progressive_444": ((23, 37), dict(quality=90, progressive=True, subsampling=0)),
    "restart_blocks": ((23, 37), dict(quality=75, restart_marker_blocks=3)),
    "restart_rows": ((23, 37), dict(quality=75, restart_marker_rows=1)),
    "progressive_restart": ((40, 56), dict(quality=85, progressive=True, restart_marker_blocks=5)),
    **{f"{s}_{h}x{w}": ((h, w), dict(quality=75, subsampling=sub))
       for h, w in ((1, 1), (9, 17)) for s, sub in (("420", 2), ("422", 1), ("444", 0))},
    **{f"progressive_{h}x{w}": ((h, w), dict(quality=90, progressive=True))
       for h, w in ((1, 1), (9, 17))},
    "gray_9x17": ((9, 17), dict(quality=60, gray=True)),
    # 4:4:0 (luma 1x2), which Pillow does not write: a 4:2:2 file with the
    # luma's factors swapped, the same MCU count at 32x32
    "440_32x32": ((32, 32), dict(quality=80, subsampling=1, luma_1x2=True)),
}


def _jpeg_file(tmp_path, case) -> str:
    (h, w), kw = JPEG_CASES[case]
    kw = dict(kw)
    gray, luma_1x2 = kw.pop("gray", False), kw.pop("luma_1x2", False)
    px = _pixels(h, w, len(case), 1 if gray else 3)
    path = tmp_path / f"{case}.jpg"
    Image.fromarray(px[..., 0] if gray else px).save(path, "JPEG", **kw)
    if luma_1x2:
        data = bytearray(path.read_bytes())
        sof = data.index(b"\xff\xc0")
        assert data[sof + 11] == 0x21
        data[sof + 11] = 0x12
        path.write_bytes(bytes(data))
    return str(path)


@pytest.mark.parametrize("case", list(JPEG_CASES))
def test_load_jpeg_matches_jax(tmp_path, case):
    """The port's JPEG decode (Python entropy decoder: the module's
    builders are patched to NumPy) and linearization, bit for bit."""
    path = _jpeg_file(tmp_path, case)
    got, want = tenv.load_image(path), jenv.load_image(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _real_native(monkeypatch):
    """Undo the module's NumPy-builder patch for this test; skips without g++."""
    if native._load() is None:
        pytest.skip("no g++: the native library is not built")
    monkeypatch.setattr(native, "available", lambda: True)


@pytest.mark.parametrize("case", list(JPEG_CASES))
def test_native_jpeg_decode_matches_python(tmp_path, monkeypatch, case):
    """The native entropy decoder and inverse DCT against the Python ones:
    coefficients of every scan and the decoded bytes equal."""
    data = open(_jpeg_file(tmp_path, case), "rb").read()
    scans = {}

    def recording(impl):
        def run(ent, starts, coefs, *rest):
            rc = impl(ent, starts, coefs, *rest)
            scans.setdefault(impl.__name__, []).append([c.copy() for c in coefs])
            return rc
        return run

    want = imageio.decode_jpeg(data)
    monkeypatch.setattr(imageio, "_decode_scan_py", recording(imageio._decode_scan_py))
    imageio.decode_jpeg(data)
    _real_native(monkeypatch)
    monkeypatch.setattr(native, "jpeg_decode_scan", recording(native.jpeg_decode_scan))
    got = imageio.decode_jpeg(data)
    np.testing.assert_array_equal(got, want)
    py, nat = scans["_decode_scan_py"], scans["jpeg_decode_scan"]
    assert len(py) == len(nat) >= 1
    for a, b in zip(py, nat):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["12-bit", "lossless", "hierarchical", "sampling", "two-component"])
def test_unsupported_jpeg_raises(tmp_path, case):
    """What the port does not read raises, naming the file and what it
    lacks (Pillow reads some of them: arithmetic and 12-bit files through
    libjpeg-turbo)."""
    buf = io.BytesIO()
    Image.fromarray(_pixels(16, 16, 0)).save(buf, "JPEG", quality=75)
    data = bytearray(buf.getvalue())
    sof = data.index(b"\xff\xc0")
    what = {"12-bit": "12-bit", "lossless": "lossless", "hierarchical": "hierarchical",
            "sampling": "sampling factors", "two-component": "2-component"}[case]
    if case == "12-bit":
        data[sof + 4] = 12
    elif case == "lossless":
        data[sof + 1] = 0xC3
    elif case == "hierarchical":
        data[sof + 1] = 0xC5
    elif case == "sampling":
        data[sof + 11] = 0x32  # Y at 3x2 against Cb at 2x1: a ratio of 3 / 2, which libjpeg refuses
        data[sof + 14] = 0x21
    else:
        data[sof + 9] = 2
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=what) as err:
        tenv.load_image(path)
    assert str(path) in str(err.value)


@pytest.mark.parametrize("case", ["png", "jpeg-python", "jpeg-native"])
def test_corrupt_files_raise_value_error(monkeypatch, case):
    """Files with random bytes overwritten or cut short decode to an image
    or raise ``ValueError``: no other exception, and no read outside the
    native decoder's buffers (baseline, progressive and restart files)."""
    rng = np.random.default_rng(len(case))
    files = []
    for kw in ([{}] if case == "png" else
               [dict(quality=75), dict(quality=80, progressive=True),
                dict(quality=90, subsampling=0, restart_marker_blocks=2),
                dict(quality=70, progressive=True, restart_marker_blocks=3)]):
        buf = io.BytesIO()
        Image.fromarray(_pixels(11, 19, 3)).save(buf, "PNG" if case == "png" else "JPEG", **kw)
        files.append(buf.getvalue())
    if case == "jpeg-native":
        _real_native(monkeypatch)
    for i in range(40 if case == "jpeg-python" else 160):  # the Python decoder is ~50x slower
        data = bytearray(files[i % len(files)])
        for j in rng.integers(8, len(data), rng.integers(1, 5)):
            data[j] = rng.integers(0, 256)
        if i % 5 == 0:
            data = data[:rng.integers(10, len(data))]
        try:
            out = imageio.decode_image(bytes(data), "corrupt")
        except ValueError as err:
            assert "corrupt" in str(err)
        else:
            assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3


def test_jpeg_digests_match_pillow(monkeypatch):
    """``assets/jpeg_digests.json`` holds the SHA-256 of Pillow's
    ``convert("RGB")`` bytes of each committed JPEG (the card's machine,
    without Pillow, holds the port to them); the port's decode matches."""
    monkeypatch.chdir(REPO)
    digests = json.loads(open(os.path.join("assets", "jpeg_digests.json")).read())
    assert set(digests) == {"assets/sky.jpg", "assets/sky_progressive.jpg"}
    for path, d in digests.items():
        want = np.asarray(Image.open(path).convert("RGB"))
        assert list(want.shape) == d["shape"] == [256, 512, 3]
        assert hashlib.sha256(want.tobytes()).hexdigest() == d["sha256"]
        got = imageio.decode_image(open(path, "rb").read(), path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == d["sha256"]
    prog = open(os.path.join("assets", "sky_progressive.jpg"), "rb").read()
    assert b"\xff\xc2" in prog and b"\xff\xdd" in prog  # progressive, restart intervals


# --- PNG, read ---


def _png_file(px, depth, ctype, palette=None, trns=None, interlace=False) -> bytes:
    """A PNG of samples ``px [H, W, ch]`` at ``depth`` bits, written by
    hand (Pillow writes neither Adam7 nor every depth): row ``y`` of each
    (sub)image filtered with type ``y % 5``."""
    h, w, ch = px.shape

    def scanlines(sub):
        sh, sw = sub.shape[:2]
        if depth == 16:
            rows = sub.astype(">u2").reshape(sh, sw * ch).view(np.uint8).reshape(sh, -1)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(sh, sw * ch)
        else:
            bits = (sub[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(sh, sw * depth).astype(np.uint8), axis=1)
        bpp = max(1, depth * ch // 8)
        out, prior = bytearray(), np.zeros(rows.shape[1], np.int64)
        for y, row in enumerate(rows.astype(np.int64)):
            a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
            c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
            p = a + prior - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
            pred = [0, a, prior, (a + prior) >> 1, paeth][y % 5]
            out.append(y % 5)
            out += ((row - pred) & 255).astype(np.uint8).tobytes()
            prior = row
        return bytes(out)

    if interlace:
        raw = b"".join(scanlines(px[y0::dy, x0::dx]) for x0, y0, dx, dy in imageio._ADAM7
                       if x0 < w and y0 < h)
    else:
        raw = scanlines(px)

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
            + (chunk(b"PLTE", palette.tobytes()) if palette is not None else b"")
            + (chunk(b"tRNS", trns) if trns is not None else b"")
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


PNG_CASES = {
    **{f"type{t}_{d}bit": (t, d, False) for t, ds in imageio._DEPTHS.items() for d in ds
       if (t, d) != (0, 16)},  # 16-bit gray: test_sixteen_bit_gray_diverges
    "adam7_rgb_8bit": (2, 8, True), "adam7_rgba_16bit": (6, 16, True),
    "adam7_gray_2bit": (0, 2, True), "adam7_palette_4bit": (3, 4, True),
    "palette_4bit_trns": (3, 4, False),
}


@pytest.mark.parametrize("case", list(PNG_CASES))
def test_load_png_matches_jax(tmp_path, case):
    """Every colour type at every bit depth it allows, Adam7 and a 4-bit
    palette with ``tRNS`` (and indices past its 11-entry PLTE chunk)."""
    ctype, depth, interlace = PNG_CASES[case]
    rng = np.random.default_rng(len(case))
    h, w, ch = 13, 11, imageio._CHANNELS[ctype]
    top = (1 << depth) - 1
    palette = trns = None
    if ctype == 3:
        palette = rng.integers(0, 256, (11, 3), dtype=np.uint8)
        trns = bytes([0, 128]) if case.endswith("trns") else None
    if ctype == 0 and depth == 8:
        trns = b"\x00\x07"  # a gray tRNS: dropped
    px = rng.integers(0, top + 1, (h, w, ch), dtype=np.int64)
    path = tmp_path / f"{case}.png"
    path.write_bytes(_png_file(px, depth, ctype, palette, trns, interlace))
    got, want = tenv.load_image(path), jenv.load_image(path)
    assert got.shape == want.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_sixteen_bit_gray_diverges(tmp_path):
    """16-bit gray (Pillow's mode ``I;16``): Pillow's ``convert("RGB")``
    clips each sample to 255, so the JAX package loads such a sky nearly
    white; the port takes the high byte, as Pillow does for every other
    16-bit type. The two agree where those rules agree (0 and 65280 up)."""
    v = np.array([0, 1, 70, 255, 256, 300, 1000, 32768, 65279, 65280, 65535], np.int64)
    px = np.tile(v, (3, 1))[..., None]
    path = tmp_path / "gray16.png"
    path.write_bytes(_png_file(px, 16, 0))
    assert Image.open(path).mode == "I;16"

    def lin(b):
        return np.power(np.repeat(b[..., None], 3, 2).astype(np.float32) / 255.0, 2.2).astype(np.float32)

    np.testing.assert_array_equal(jenv.load_image(path), lin(np.minimum(px[..., 0], 255)))
    np.testing.assert_array_equal(tenv.load_image(path), lin(px[..., 0] >> 8))
    same = (v == 0) | (v >= 65280)
    np.testing.assert_array_equal((tenv.load_image(path) == jenv.load_image(path)).all(axis=(0, 2)), same)


# --- writing ---

WRITE_CASES = [f"{writer}_{h}x{w}" for writer in ("save_image", "save_png", "stream")
               for h, w in ((1, 1), (9, 17), (23, 37), (16, 32))]


@pytest.mark.parametrize("case", WRITE_CASES)
def test_jpeg_writers_match_jax(tmp_path, monkeypatch, case):
    """Pillow's decode of the port's JPEG equals Pillow's decode of the JAX
    package's for the same pixels: ``save_image`` and ``save_png`` to a
    JPEG extension (quality 75; both films tonemapped to the same image,
    as the two tonemaps may round an ulp apart) and the live view's parts
    (quality 88). The encoder writes Pillow's own bytes here, so the files
    are compared too."""
    writer, size = case.rsplit("_", 1)
    h, w = map(int, size.split("x"))
    rgb01 = np.random.default_rng(h * w).uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32)
    if writer == "save_image":
        tenv.save_image(tmp_path / "t.jpg", rgb01)
        jenv.save_image(tmp_path / "j.jpg", rgb01)
    elif writer == "save_png":
        monkeypatch.setattr(tfilm, "film_to_srgb", lambda film: torch.from_numpy(rgb01))
        monkeypatch.setattr(jfilm, "film_to_srgb", lambda film: rgb01)
        film = np.ones((h, w, 4), np.float32)
        tfilm.save_png(tmp_path / "t.JPEG", torch.from_numpy(film))
        jfilm.save_png(tmp_path / "j.JPEG", film)
    if writer == "stream":
        rgb8 = np.clip(rgb01 * 255.0, 0, 255).astype(np.uint8)
        mine, theirs = imageio.encode_jpeg(rgb8, 88), jstream._jpeg(rgb01)
    else:
        ext = ".jpg" if writer == "save_image" else ".JPEG"
        mine, theirs = (tmp_path / f"t{ext}").read_bytes(), (tmp_path / f"j{ext}").read_bytes()
    assert mine[:3] == b"\xff\xd8\xff"

    def pillow(data):
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))

    np.testing.assert_array_equal(pillow(mine), pillow(theirs))
    assert mine == theirs


@pytest.mark.parametrize("case", ["odd", "even"])
def test_native_jpeg_encode_matches_python(monkeypatch, case):
    """The native forward DCT, quantizer and Huffman encoder against the
    NumPy and Python ones: the same file."""
    h, w = (37, 23) if case == "odd" else (32, 48)
    px = _pixels(h, w, 7)
    want = imageio.encode_jpeg(px, 90)
    _real_native(monkeypatch)
    assert imageio.encode_jpeg(px, 90) == want


def test_native_dct_matches_numpy(monkeypatch):
    """The native DCTs on blocks out of any encoder's range: the IDCT's C
    ``int`` workspace wrap and post-IDCT range-limit table, extreme
    samples and 16-bit quantization tables."""
    _real_native(monkeypatch)
    rng = np.random.default_rng(11)
    coef = rng.integers(-32768, 32768, (300, 64)).astype(np.int16)
    coef[:100] //= 64
    q = rng.integers(1, 65536, 64)
    np.testing.assert_array_equal(native.jpeg_idct_islow(coef, q), imageio._idct_islow_np(coef, q))
    samples = rng.integers(0, 256, (300, 64)).astype(np.uint8)
    samples[:8] = rng.choice([0, 255], (8, 64))
    for quality in (1, 50, 100):
        for table in imageio.jpeg_quant_tables(quality):
            np.testing.assert_array_equal(native.jpeg_fdct_quantize(samples, *imageio._divisors(table)),
                                          imageio._fdct_quantize_np(samples, table))


@pytest.mark.parametrize("out", ["x.jpg", "x.JPEG", "x.png", "x.webp", "x.avif", "x"])
def test_cli_out_extension(tmp_path, monkeypatch, out):
    """``--out`` takes the format of its extension, as the JAX package's
    ``Image.save``; one Pillow would not write to (or any the port does
    not: AVIF) raises before the scene is built, not after the render.
    ``.webp`` is the port's lossy frame, which Pillow reads to the pixels
    the port reads."""
    built = []
    real = cli.load_scene
    monkeypatch.setattr(cli, "load_scene", lambda args: built.append(1) or real(args))
    argv = ["--scene", "env_sphere_scene", "--width", "4", "--height", "4", "--spp", "1",
            "--max-bounces", "2", "--device", "cpu", "--out", str(tmp_path / out)]
    if out in ("x.avif", "x"):
        with pytest.raises(ValueError, match="unknown file extension"):
            cli.main(argv)
        assert not built
        return
    res = cli.main(argv)
    data = (tmp_path / out).read_bytes()
    rgb8 = np.clip(tfilm.film_to_srgb(res["film"]).numpy() * 255.0, 0, 255).astype(np.uint8)[::-1]
    if out == "x.png":
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), rgb8)
        return
    if out == "x.webp":
        assert data == webp.encode_webp(np.ascontiguousarray(rgb8))
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")),
                                      imageio.decode_image(data))
        return
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb8), "RGB").save(buf, "JPEG")
    assert data == buf.getvalue()


# --- the JPEG-sky scene ---


def test_jpeg_sky_scene_renders_like_jax(monkeypatch):
    """``assets/asset_scene_jpeg.json`` (``asset_scene.json`` under
    ``sky.jpg``): host tables, sky included, equal to the JAX package's;
    a 16x16 2-spp render held to the JAX render (Pallas dense kernels in
    interpret mode)."""
    monkeypatch.chdir(REPO)
    jsh, tsh = jconfig.load_scene_json(JPEG_SCENE), tconfig.load_scene_json(JPEG_SCENE)
    assert tsh.num_world_tris == 13832 and tsh.env.shape == (256, 512, 3)
    _assert_scenes_equal(jsh, tsh)
    _assert_slice_agrees(*_render_pair(jsh, tsh, tconfig.load_camera_json(JPEG_SCENE, 1.0)))
