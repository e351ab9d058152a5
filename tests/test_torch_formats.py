"""The port's TIFF, GIF, BMP/DIB, PPM-family and TGA codecs, APNG and the
4-component and any-sampling JPEG (``path_tracer_tpu_torch/utils/``)
against the JAX package's Pillow loader and writer.

Reading: ``envmap.load_image`` equals the JAX package's bit for bit on
every variant (files written here with Pillow, or built byte by byte in
the builders below where Pillow cannot write them: 16-bit and tiled or
planar TIFF, run-length and OS/2 BMP, type 9/11 TGA, interlaced or
partial-frame GIF, 3x / 4x sampled and YCCK JPEG); gray above
8 bits is the one divergence (Pillow clips, the port keeps the high byte),
asserted as such. Writing: every extension's bytes equal Pillow's file for
the same pixels (GIF included). Each native loop equals its Python twin,
corrupt files raise only ``ValueError``, the committed digests equal
Pillow's, the TIFF-sky scene's host tables equal the PNG-sky scene's, and
``--out`` takes every new extension.

``PYTHONPATH=. python tests/test_torch_formats.py`` rewrites the phase-26
format assets (``assets/sky.tif`` and ``assets/format_*``) and
``assets/format_digests.json``, the SHA-256 of Pillow's ``convert("RGB")``
bytes of each, which ``chip_smoke.py`` holds the port's decoders to on the
card's machine (no Pillow there).
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image
from test_torch_inputs import _assert_scenes_equal

from path_tracer_tpu import native as jnative
from path_tracer_tpu.scene import envmap as jenv
from path_tracer_tpu.utils import config as jconfig
from path_tracer_tpu_torch import cli, native
from path_tracer_tpu_torch.film import film as tfilm
from path_tracer_tpu_torch.scene import envmap as tenv
from path_tracer_tpu_torch.utils import bmp, gif, imageio, netpbm, tga, tiff
from path_tracer_tpu_torch.utils import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- file builders ---


def pixels(h, w, seed, channels=3):
    """A smooth pattern with noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5 + c) * np.cos(y / 4 - c) for c in range(channels)], -1)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)


def pillow(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


# --- TIFF ---


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more as repeats, the rest as literals."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < len(data) and j - i < 128 and not (j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_file(samples: np.ndarray, bits: int, photometric: int, *, order="<", compression=1,
              predictor=1, planar=1, tile=None, rows_per_strip=None, extra=(), colormap=None,
              sample_format=None) -> bytes:
    """A TIFF of ``samples [h, w, spp]`` (values < 2^bits) with the given
    layout; compression 1 (none), 8 (Deflate) or 32773 (PackBits)."""
    h, w, spp = samples.shape
    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    bw, bh = tile if tile else (w, rows_per_strip or h)
    blocks = []
    for plane in planes:
        sp = plane.shape[2]
        for y in range(0, h, bh):
            for x in range(0, w, bw):
                blk = np.zeros((bh if tile else min(bh, h - y), bw, sp), np.int64)
                part = plane[y:y + bh, x:x + bw]
                blk[:part.shape[0], :part.shape[1]] = part
                if predictor == 2:
                    blk = np.diff(blk, axis=1, prepend=0) % (1 << bits)
                if bits == 16:
                    raw = blk.astype(order + "u2").tobytes()
                elif bits == 8:
                    raw = blk.astype(np.uint8).tobytes()
                else:
                    v = blk.reshape(blk.shape[0], -1)
                    bitrows = ((v[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(v.shape[0], -1)
                    raw = np.packbits(bitrows.astype(np.uint8), axis=1).tobytes()
                raw = {1: raw, 8: zlib.compress(raw), 32773: packbits(raw)}[compression]
                blocks.append(raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, list(colormap))
    if sample_format is not None:
        tags[339] = (3, [sample_format] * spp)
    if tile:
        tags.update({322: (4, [bw]), 323: (4, [bh]), 324: (4, [0] * len(blocks)),
                     325: (4, [len(b) for b in blocks])})
    else:
        tags.update({273: (4, [0] * len(blocks)), 278: (4, [bh]), 279: (4, [len(b) for b in blocks])})
    pos = 8 + 2 + 12 * len(tags) + 4
    heap, entries = b"", []
    data_at = pos + sum(n for n in (len(v) * (2 if t == 3 else 4) for t, v in tags.values()) if n > 4)
    offsets = np.cumsum([data_at] + [len(b) for b in blocks])[:-1].tolist()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if tag in (273, 324):
            vals = offsets
        packed = struct.pack(order + ("H" if typ == 3 else "I") * len(vals), *vals)
        if len(packed) <= 4:
            entries.append(struct.pack(order + "HHI", tag, typ, len(vals)) + packed.ljust(4, b"\0"))
        else:
            entries.append(struct.pack(order + "HHII", tag, typ, len(vals), pos + len(heap)))
            heap += packed
    head = (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(order + "I", 8)
    return head + struct.pack(order + "H", len(entries)) + b"".join(entries) + b"\0\0\0\0" + heap + b"".join(blocks)


# --- BMP ---


def rle8(idx: np.ndarray) -> bytes:
    """BI_RLE8 of ``idx [h, w]`` (file row order: bottom-up): runs of 3 or
    more encoded, literals of 3 or more in absolute mode (word-aligned),
    shorter ones as runs of 1; an end-of-line after each row, end of
    bitmap last."""
    out = bytearray()
    for row in idx[::-1].tolist():
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 3:
                out += bytes([j - i, row[i]])
                i = j
                continue
            j = i
            while j < len(row) and j - i < 255 and not (j + 2 < len(row) and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            if j - i >= 3:
                out += bytes([0, j - i]) + bytes(row[i:j]) + (b"\0" if (j - i) % 2 else b"")
            else:
                for v in row[i:j]:
                    out += bytes([1, v])
            i = j
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_file(w, h, bits, body: bytes, *, compression=0, palette=b"", colors=0, hsize=40,
             masks=None, top_down=False, file_header=True) -> bytes:
    """A BMP (or, without the file header, a DIB) around ``body``."""
    extra = b""
    if hsize == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1, bits, compression,
                           len(body), 2835, 2835, colors, 0)
        if hsize > 40:
            info += struct.pack("<IIII", *(masks or (0, 0, 0, 0)))[:hsize - 40] + bytes(max(hsize - 56, 0))
        elif masks:
            extra = struct.pack("<III", *masks[:3])
    off = 14 + len(info) + len(extra) + len(palette)
    head = b"BM" + struct.pack("<III", off + len(body), 0, off) if file_header else b""
    return head + info + extra + palette + body


def bmp_palette(rgb: np.ndarray, pad=4) -> bytes:
    return b"".join(bytes([b, g, r]) + bytes(pad - 3) for r, g, b in rgb.tolist())


# --- TGA ---


def tga_rle(px: np.ndarray) -> bytes:
    """TGA run-length packets of ``px [h, w, bpp]`` (file row order), runs
    of 2 or more as run packets, the rest as raw packets, none across a
    row."""
    out = bytearray()
    for row in px:
        cells = [bytes(c) for c in row.reshape(row.shape[0], -1)]
        i = 0
        while i < len(cells):
            j = i
            while j < len(cells) and j - i < 128 and cells[j] == cells[i]:
                j += 1
            if j - i >= 2:
                out += bytes([0x80 | (j - i - 1)]) + cells[i]
                i = j
                continue
            j = i + 1
            while j < len(cells) and j - i < 128 and not (j + 1 < len(cells) and cells[j] == cells[j + 1]):
                j += 1
            out += bytes([j - i - 1]) + b"".join(cells[i:j])
            i = j
    return bytes(out)


def tga_file(kind, w, h, depth, body, *, cmap=None, map_depth=24, first=0, flags=0, image_id=b"") -> bytes:
    """A TGA of image type ``kind`` around ``body`` (``cmap``: the map's
    entry bytes)."""
    length = 0 if cmap is None else len(cmap) // (map_depth // 8 if map_depth != 15 else 2)
    head = struct.pack("<BBBHHBHHHHBB", len(image_id), 0 if cmap is None else 1, kind, first, length,
                       map_depth if cmap is not None else 0, 0, 0, w, h, depth, flags)
    return head + image_id + (cmap or b"") + body


# --- GIF ---


def gif_file(idx: np.ndarray, table: np.ndarray, *, screen=None, at=(0, 0), local=False,
             interlace=False, transparency=None, min_size=8, version=b"GIF89a", coded=None) -> bytes:
    """A one-frame GIF of indices ``idx [h, w]`` with colour table ``table
    [2^k, 3]``, global or local, at ``at`` on a ``screen`` (w, h); only the
    first ``coded`` pixels coded, if given."""
    h, w = idx.shape
    sw, sh = screen or (w, h)
    size = int(np.log2(len(table))) - 1
    out = version + struct.pack("<HHBBB", sw, sh, 0 if local else 128 | size, 0, 0)
    if not local:
        out += table.astype(np.uint8).tobytes()
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1, 0, 0, transparency]) + b"\0"
    out += b"!\xfe\x05hello\0"  # a comment extension
    out += b"," + struct.pack("<HHHHB", at[0], at[1], w, h, (64 if interlace else 0) | ((128 | size) if local else 0))
    if local:
        out += table.astype(np.uint8).tobytes()
    codes = gif._lzw_encode_py(idx[gif._rows(h, interlace)].reshape(-1)[:coded], min_size)
    blocks = b"".join(bytes([len(codes[i:i + 200])]) + codes[i:i + 200] for i in range(0, len(codes), 200))
    return out + bytes([min_size]) + blocks + b"\0;"


# --- JPEG ---


def jpeg_sampled(planes, factors, quality=85, marker="jfif") -> bytes:
    """A baseline JPEG of full-size uint8 ``planes`` (Y, Cb, Cr or four
    CMYK / YCCK planes) at the given (h, v) sampling factors, the chroma
    planes subsampled by picking; ``marker``: ``jfif``, ``none`` or
    ``adobe0`` / ``adobe1`` / ``adobe2`` (the APP14 transform)."""
    hgt, wid = planes[0].shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mx, my = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    qt = imageio.jpeg_quant_tables(quality)
    grids = []
    for i, (p, (h, v)) in enumerate(zip(planes, factors)):
        cw, ch = -(-wid * h // hmax), -(-hgt * v // vmax)
        sub = p[(np.arange(ch) * vmax // v).clip(0, hgt - 1)][:, (np.arange(cw) * hmax // h).clip(0, wid - 1)]
        full = imageio._pad_edge(sub, my * v * 8, mx * h * 8)
        q = imageio._fdct_quantize(imageio._blocks(full, my * v, mx * h), qt[min(i, 1)])
        grids.append(q.reshape(my * v, mx * h, 64))
    blocks, sel = [], []
    for y in range(my):
        for x in range(mx):
            for i, (h, v) in enumerate(factors):
                for by in range(v):
                    for bx in range(h):
                        blocks.append(grids[i][y * v + by, x * h + bx])
                        sel.append(i)
    keys = ("dc0", "ac0") + ("dc1", "ac1") * (len(planes) - 1)
    tabs = [imageio._encode_table(*imageio._STD_HUFF[k]) for k in keys]
    ent = imageio._encode_scan(np.array(blocks, np.int16), np.array(sel, np.int32),
                               [t[0] for t in tabs], [t[1] for t in tabs])

    def seg(m, b):
        return bytes([0xFF, m]) + struct.pack(">H", len(b) + 2) + b

    app = imageio._JFIF_APP0 if marker == "jfif" else b"" if marker == "none" else \
        seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([int(marker[-1])]))
    n = len(planes)
    dqt = b"".join(seg(0xDB, bytes([i]) + t[imageio._ZIGZAG].astype(np.uint8).tobytes()) for i, t in enumerate(qt))
    sof = seg(0xC0, struct.pack(">BHHB", 8, hgt, wid, n)
              + b"".join(bytes([i + 1, h << 4 | v, min(i, 1)]) for i, (h, v) in enumerate(factors)))
    dht = b"".join(seg(0xC4, bytes([c << 4 | t]) + bytes(imageio._STD_HUFF[k][0]) + imageio._STD_HUFF[k][1])
                   for c, t, k in ((0, 0, "dc0"), (1, 0, "ac0"), (0, 1, "dc1"), (1, 1, "ac1")))
    sos = seg(0xDA, bytes([n]) + b"".join(bytes([i + 1, 0 if i == 0 else 0x11]) for i in range(n)) + bytes([0, 63, 0]))
    return b"\xff\xd8" + app + dqt + sof + dht + sos + ent + b"\xff\xd9"


# --- the committed assets ---

DIGESTS = "assets/format_digests.json"


def asset_files() -> dict:
    """``{repo path: bytes}`` of phase 26's format assets, made from
    ``assets/sky.png`` (512x256)."""
    sky = np.asarray(Image.open(os.path.join(REPO, "assets", "sky.png")).convert("RGB"))
    crop = sky[64:160, 128:320]  # 192x96 (the PPM 96x48): the BMP and PPM are crops
    y, x = np.mgrid[0:48, 0:64]
    wide = np.stack([x * 1021 + y * 7, y * 1301 + x * 3, (x + y) * 571], -1) % 65536
    pal_img = Image.fromarray(crop).convert("P", palette=Image.Palette.ADAPTIVE)
    idx = np.asarray(pal_img)
    pal = np.array(pal_img.getpalette(), np.uint8).reshape(-1, 3)
    ycc = imageio._rgb_to_ycc(sky)
    cmyk = np.asarray(Image.fromarray(sky).convert("CMYK"))
    small = crop[:48, :96]
    ppm = b"P3\n# a crop of assets/sky.png at maxval 1023\n%d %d\n1023\n" % (small.shape[1], small.shape[0])
    ppm += b"\n".join(b" ".join(b"%d" % (v * 1023 // 255) for v in row)
                      for row in small.reshape(small.shape[0], -1).tolist()) + b"\n"
    return {
        "assets/sky.tif": pillow(Image.fromarray(sky), "TIFF", compression="tiff_lzw", tiffinfo={317: 2}),
        "assets/format_rgb16_tiles.tif": tiff_file(wide, 16, 2, order=">", compression=8, predictor=2,
                                                   tile=(32, 32)),
        "assets/format_sky.gif": pillow(Image.fromarray(sky), "GIF"),
        "assets/format_sky_rle.tga": pillow(Image.fromarray(sky), "TGA", rle=True),
        "assets/format_crop_rle8.bmp": bmp_file(crop.shape[1], crop.shape[0], 8, rle8(idx), compression=1,
                                                palette=bmp_palette(pal), colors=len(pal)),
        "assets/format_crop_ascii.ppm": ppm,
        "assets/format_sky_cmyk.jpg": pillow(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=85),
        "assets/format_sky_411.jpg": jpeg_sampled(list(ycc), ((4, 1), (1, 1), (1, 1)), quality=85),
    }


def write_assets() -> None:
    """Write the assets and their digests (Pillow's decode of each)."""
    digests = {}
    for rel, data in asset_files().items():
        with open(os.path.join(REPO, rel), "wb") as f:
            f.write(data)
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        digests[rel] = {"shape": list(rgb.shape), "bytes": len(data),
                        "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    with open(os.path.join(REPO, DIGESTS), "w") as f:
        f.write(json.dumps(digests, indent=1) + "\n")


# --- the cases ---

RGB = pixels(29, 45, 1)
WIDE = (np.arange(29 * 45 * 3).reshape(29, 45, 3) * 2731 + 17) % 65536  # 16-bit samples


def _pal_img(px=RGB, colors=50):
    return Image.fromarray(px).convert("P", palette=Image.Palette.ADAPTIVE, colors=colors)


def _cmap16(n):
    """A TIFF colour map of ``n`` entries: R, then G, then B, 16 bits."""
    rng = np.random.default_rng(n)
    return rng.integers(0, 65536, 3 * n).tolist()


def _rle4_body(idx):
    """BI_RLE4 of 4-bit ``idx`` rows: a run of 5 (two alternating nibbles),
    an even absolute run of 4, the rest as runs of 1, end of line."""
    out = bytearray()
    for row in idx[::-1].tolist():
        out += bytes([5, row[0] << 4 | row[1]])
        out += bytes([0, 4, row[5] << 4 | row[6], row[7] << 4 | row[8]])
        for v in row[9:]:
            out += bytes([1, v << 4])
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _delta_body(idx):
    """BI_RLE8 with a delta escape on the first row (Pillow reads the two
    bytes after the escape's own two) and an early end of line."""
    rows = idx[::-1].tolist()
    out = bytearray([3, rows[0][0], 0, 2, 9, 9, 2, 0])
    out += bytes([0, len(rows[0]) - 5]) + bytes(rows[0][5:]) + (b"\0" if (len(rows[0]) - 5) % 2 else b"")
    out += b"\0\0"
    for row in rows[1:]:
        out += bytes([4, row[0]]) + b"\0\0"
    return bytes(out + b"\0\1")


def _gif_table(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, 3))


def _gif_anim():
    frames = [Image.fromarray(RGB), Image.fromarray(pixels(29, 45, 2))]
    return pillow(frames[0], "GIF", save_all=True, append_images=frames[1:])


def _apng():
    frames = [Image.fromarray(RGB), Image.fromarray(pixels(29, 45, 2))]
    return pillow(frames[0], "PNG", save_all=True, append_images=frames[1:])


_IDX16 = np.random.default_rng(4).integers(0, 16, (7, 13))
_IDX256 = np.random.default_rng(5).integers(0, 256, (9, 14))
_IDX_GRAY = np.random.default_rng(6).integers(0, 4, (12, 20))
_Y, _CB, _CR = imageio._rgb_to_ycc(RGB)
_CMYK = pixels(29, 45, 7, 4)

READ_CASES = {
    # TIFF
    "tiff_rgb_raw": lambda: pillow(Image.fromarray(RGB), "TIFF"),
    "tiff_rgb_lzw_predictor": lambda: pillow(Image.fromarray(RGB), "TIFF", compression="tiff_lzw",
                                             tiffinfo={317: 2, 278: 7}),
    "tiff_rgb_deflate": lambda: pillow(Image.fromarray(RGB), "TIFF", compression="tiff_deflate"),
    "tiff_rgb_adobe_deflate_predictor": lambda: pillow(Image.fromarray(RGB), "TIFF",
                                                       compression="tiff_adobe_deflate", tiffinfo={317: 2}),
    "tiff_rgb_packbits": lambda: pillow(Image.fromarray(RGB), "TIFF", compression="packbits"),
    "tiff_rgba_lzw": lambda: pillow(Image.fromarray(pixels(29, 45, 2, 4)), "TIFF", compression="tiff_lzw"),
    "tiff_gray8_lzw": lambda: pillow(Image.fromarray(RGB[..., 0]), "TIFF", compression="tiff_lzw"),
    "tiff_gray_alpha": lambda: pillow(Image.fromarray(RGB[..., :2], "LA"), "TIFF", compression="tiff_deflate"),
    "tiff_bilevel_packbits": lambda: pillow(Image.fromarray(RGB[..., 0] > 128), "TIFF", compression="packbits"),
    "tiff_palette8_lzw": lambda: pillow(_pal_img(), "TIFF", compression="tiff_lzw"),
    "tiff_rgb16_be_tiles_deflate_predictor": lambda: tiff_file(WIDE, 16, 2, order=">", compression=8,
                                                               predictor=2, tile=(16, 16)),
    "tiff_rgb16_le_planar_packbits": lambda: tiff_file(WIDE, 16, 2, compression=32773, planar=2,
                                                       rows_per_strip=8),
    "tiff_rgb8_planar_tiles_deflate": lambda: tiff_file(RGB, 8, 2, compression=8, planar=2, tile=(16, 32),
                                                        predictor=2),
    "tiff_rgba16_unassociated": lambda: tiff_file(np.dstack([WIDE, WIDE[..., :1]]), 16, 2, extra=(2,)),
    "tiff_rgba8_associated": lambda: tiff_file(np.dstack([RGB // 2, np.full(RGB.shape[:2], 128)]), 8, 2,
                                               extra=(1,), order=">"),
    "tiff_gray4_white_is_zero": lambda: tiff_file(_IDX16[..., None], 4, 0, compression=32773),
    "tiff_gray4": lambda: tiff_file(_IDX16[..., None], 4, 1, order=">", compression=8),
    "tiff_gray2": lambda: tiff_file(_IDX_GRAY[..., None], 2, 1),
    "tiff_gray1_white_is_zero": lambda: tiff_file((_IDX16 & 1)[..., None], 1, 0, rows_per_strip=3),
    "tiff_palette4_cmap16": lambda: tiff_file(_IDX16[..., None], 4, 3, colormap=_cmap16(16)),
    "tiff_palette8_tiles": lambda: tiff_file(_IDX256[..., None], 8, 3, colormap=_cmap16(256),
                                             tile=(16, 16), compression=8),
    "tiff_gray8_signed": lambda: tiff_file(RGB[..., :1], 8, 1, sample_format=2),
    # GIF
    "gif_pillow_interlaced": lambda: pillow(Image.fromarray(RGB), "GIF"),
    "gif_pillow_small": lambda: pillow(Image.fromarray(RGB[:9, :13]), "GIF"),
    "gif_pillow_palette_image": lambda: pillow(_pal_img(colors=16), "GIF"),
    "gif_animated_frame0": _gif_anim,
    "gif87a_global_subframe": lambda: gif_file(_IDX16, _gif_table(16), screen=(20, 11), at=(4, 2),
                                               min_size=4, version=b"GIF87a"),
    "gif89a_local_interlaced_transparency": lambda: gif_file(_IDX256[:, :13], _gif_table(256), local=True,
                                                             interlace=True, transparency=7,
                                                             screen=(16, 12), at=(1, 1)),
    "gif_frame_overruns_screen": lambda: gif_file(_IDX16, _gif_table(16), screen=(8, 5), at=(3, 2), min_size=5),
    "gif_gray_ramp_table": lambda: gif_file(_IDX_GRAY, np.repeat(np.arange(4)[:, None], 3, 1), min_size=2),
    "gif_index_past_table": lambda: gif_file(_IDX16, _gif_table(4), min_size=4),
    # BMP / DIB
    "bmp_rgb24": lambda: pillow(Image.fromarray(RGB), "BMP"),
    "bmp_rgba32": lambda: pillow(Image.fromarray(pixels(29, 45, 3, 4)), "BMP"),
    "bmp_palette8": lambda: pillow(_pal_img(), "BMP"),
    "bmp_gray8": lambda: pillow(Image.fromarray(RGB[..., 1]), "BMP"),
    "bmp_bilevel": lambda: pillow(Image.fromarray(RGB[..., 0] > 128), "BMP"),
    "dib_rgb24": lambda: pillow(Image.fromarray(RGB), "DIB"),
    "dib_palette8_built": lambda: bmp_file(14, 9, 8, _IDX256.astype(np.uint8)[::-1].tobytes().ljust(16 * 9),
                                           palette=bmp_palette(_gif_table(256)), file_header=False),
    "bmp_os2_palette8": lambda: bmp_file(14, 9, 8, np.pad(_IDX256.astype(np.uint8), ((0, 0), (0, 2)))[::-1].tobytes(),
                                         hsize=12, palette=bmp_palette(_gif_table(256), pad=3)),
    "bmp_os2_rgb24": lambda: bmp_file(8, 3, 24, RGB[:3, :8, ::-1][::-1].tobytes(), hsize=12),
    "bmp_palette4_top_down": lambda: bmp_file(13, 7, 4, np.packbits(
        ((np.pad(_IDX16, ((0, 0), (0, 3)))[..., None] >> np.arange(3, -1, -1)) & 1).reshape(7, -1).astype(np.uint8),
        axis=1).tobytes(), palette=bmp_palette(_gif_table(16)), colors=16, top_down=True),
    "bmp_rle8": lambda: bmp_file(14, 9, 8, rle8(_IDX256.astype(np.uint8)), compression=1,
                                 palette=bmp_palette(_gif_table(256))),
    "bmp_rle8_delta": lambda: bmp_file(14, 9, 8, _delta_body(_IDX256), compression=1,
                                       palette=bmp_palette(_gif_table(256))),
    "bmp_rle4": lambda: bmp_file(13, 7, 4, _rle4_body(_IDX16), compression=2,
                                 palette=bmp_palette(_gif_table(16)), colors=16),
    "bmp_rgb16_555": lambda: bmp_file(6, 4, 16, (WIDE[:4, :6, 0].astype("<u2")).tobytes()),
    "bmp_bitfields_565_v3": lambda: bmp_file(6, 4, 16, (WIDE[:4, :6, 1].astype("<u2")).tobytes(),
                                             compression=3, masks=(0xF800, 0x7E0, 0x1F, 0)),
    "bmp_bitfields_555_v5": lambda: bmp_file(6, 4, 16, (WIDE[:4, :6, 2].astype("<u2")).tobytes(),
                                             compression=3, masks=(0x7C00, 0x3E0, 0x1F, 0), hsize=124),
    "bmp_bitfields32_xbgr_v4": lambda: bmp_file(5, 3, 32, (WIDE[:3, :5, 0] * 65537).astype("<u4").tobytes(),
                                                compression=3, masks=(0xFF000000, 0xFF0000, 0xFF00, 0),
                                                hsize=108),
    # the PPM family
    "ppm_p6": lambda: pillow(Image.fromarray(RGB), "PPM"),
    "ppm_p5": lambda: pillow(Image.fromarray(RGB[..., 0]), "PPM"),
    "ppm_p4": lambda: pillow(Image.fromarray(RGB[..., 0] > 128), "PPM"),
    "ppm_p1_comments": lambda: b"P1\n# a comment\n5 2\n0 1 1 0 1\n1#x\n0 0 1 0\n",
    "ppm_p2_maxval10": lambda: b"P2 3 2\n# c\n10 0 1 2 3 4 # d\n10\n",
    "ppm_p3_maxval1000": lambda: b"P3\n2 2 1000\n0 500 1000 999 1 7\n250 251 252 3 4 5\n",
    "ppm_p6_maxval300": lambda: b"P6 2 1 300\n" + np.array([0, 50, 100, 299, 1, 300], ">u2").tobytes(),
    "ppm_p5_maxval7": lambda: b"P5\n3 1\n7\n" + bytes([0, 3, 7]),
    "pfm_gray": lambda: b"Pf\n3 2\n-1.0\n" + np.array([0.5, 1.0, 200.7, -3, 300, np.nan], "<f4").tobytes(),
    # TGA
    "tga_rgb": lambda: pillow(Image.fromarray(RGB), "TGA"),
    "tga_rgb_rle": lambda: pillow(Image.fromarray(RGB), "TGA", rle=True),
    "tga_rgba_rle_top_down": lambda: pillow(Image.fromarray(pixels(29, 45, 4, 4)), "TGA", rle=True, orientation=1),
    "tga_gray": lambda: pillow(Image.fromarray(RGB[..., 2]), "TGA"),
    "tga_gray_rle": lambda: pillow(Image.fromarray(RGB[..., 2]), "TGA", rle=True),
    "tga_gray_alpha": lambda: pillow(Image.fromarray(RGB[..., :2], "LA"), "TGA"),
    "tga_bilevel": lambda: pillow(Image.fromarray(RGB[..., 0] > 128), "TGA"),
    "tga_palette": lambda: pillow(_pal_img(), "TGA"),
    "tga_palette_rle": lambda: pillow(_pal_img(), "TGA", rle=True),
    "tga_rgb15_flipped": lambda: tga_file(2, 6, 4, 16, (WIDE[:4, :6, 0].astype("<u2")).tobytes(), flags=0x10,
                                          image_id=b"id"),
    "tga_cmap16_rle_raw_across_rows": lambda: tga_file(
        9, 7, 2, 8, bytes([13]) + bytes(range(14)), cmap=(WIDE[:1, :9, 0].astype("<u2")).tobytes(),
        map_depth=16, first=3),
    "tga_rgb24_type10": lambda: tga_file(10, 8, 3, 24, tga_rle(np.repeat(RGB[:3, :8:2, ::-1], 2, 1)[::-1]),
                                         image_id=b"hello"),
    # APNG and the JPEG variants
    "apng_default_image": _apng,
    "jpeg_cmyk_adobe": lambda: pillow(Image.fromarray(_CMYK, "CMYK"), "JPEG", quality=80),
    "jpeg_cmyk_progressive": lambda: pillow(Image.fromarray(_CMYK, "CMYK"), "JPEG", progressive=True),
    "jpeg_cmyk_no_adobe": lambda: jpeg_sampled(list(np.moveaxis(_CMYK, 2, 0)), ((2, 2), (1, 1), (1, 1), (2, 2)),
                                               marker="none"),
    "jpeg_ycck": lambda: jpeg_sampled([_Y, _CB, _CR, _CMYK[..., 3]], ((2, 1), (1, 1), (1, 1), (2, 1)),
                                      marker="adobe2"),
    "jpeg_rgb_adobe0": lambda: jpeg_sampled(list(np.moveaxis(RGB, 2, 0)), ((1, 1),) * 3, marker="adobe0"),
    "jpeg_ycc_adobe1": lambda: jpeg_sampled([_Y, _CB, _CR], ((2, 2), (1, 1), (1, 1)), marker="adobe1"),
    **{f"jpeg_sampling_{a}{b}_{c}{d}": (lambda f: lambda: jpeg_sampled([_Y, _CB, _CR], f))(
        ((a, b), (c, d), (1, 1)))
       for a, b, c, d in ((4, 1, 1, 1), (1, 4, 1, 1), (4, 2, 1, 1), (3, 1, 1, 1), (3, 2, 1, 1),
                          (2, 3, 2, 1), (4, 1, 2, 1), (1, 4, 1, 2))},
}


def _case_file(tmp_path, case) -> str:
    path = tmp_path / f"{case}.img"
    path.write_bytes(READ_CASES[case]())
    return str(path)


@pytest.mark.parametrize("case", list(READ_CASES))
def test_load_matches_jax(tmp_path, case):
    """``envmap.load_image``: the decode and linearization bit for bit as
    the JAX package's Pillow loader."""
    path = _case_file(tmp_path, case)
    got, want = tenv.load_image(path), jenv.load_image(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["tiff_gray16_le", "tiff_gray16_be_lzw", "pgm_maxval65535", "pgm_maxval1000",
                                  "pgm_ascii_maxval4095"])
def test_sixteen_bit_gray_diverges(tmp_path, case):
    """Gray above 8 bits: Pillow's mode ``I;16`` / ``I`` value clips to 255
    in ``convert("RGB")``; the port keeps its high byte (``ROADMAP.md``,
    known faults of the reference). Both rules asserted."""
    gray = WIDE[..., 0]
    data = {"tiff_gray16_le": lambda: tiff_file(gray[..., None], 16, 1),
            "tiff_gray16_be_lzw": lambda: pillow(Image.fromarray(gray.astype(np.uint16)), "TIFF",
                                                 compression="tiff_lzw", tiffinfo={317: 2}),
            "pgm_maxval65535": lambda: b"P5 45 29 65535\n" + gray.astype(">u2").tobytes(),
            "pgm_maxval1000": lambda: b"P5 45 29 1000\n" + (gray % 1001).astype(">u2").tobytes(),
            "pgm_ascii_maxval4095": lambda: b"P2 45 29 4095\n" + b" ".join(b"%d" % v for v in (gray % 4096).ravel())}
    path = tmp_path / f"{case}.img"
    path.write_bytes(data[case]())
    im = Image.open(path)
    value = np.asarray(im).astype(np.int64)  # the 16-bit value Pillow holds
    assert im.mode in ("I;16", "I;16B", "I")
    want_pillow = np.minimum(value, 255)
    np.testing.assert_array_equal(np.asarray(im.convert("RGB"))[..., 0], want_pillow)
    got = imageio.decode_image(path.read_bytes(), str(path))
    np.testing.assert_array_equal(got, np.repeat((value >> 8)[..., None], 3, axis=2))
    assert (value >> 8 != want_pillow).any()


@pytest.mark.parametrize("case", ["tiff_float_rgb", "tiff_logl", "tiff_ycbcr_uncompressed", "tiff_old_jpeg",
                                  "tiff_logluv", "tiff_zstd", "pf_colour", "avif", "qoi", "jpeg_fractional",
                                  "jpeg_mcu_of_11_blocks", "gif_ends_early"])
def test_still_unsupported_raise(tmp_path, case):
    """What the port does not read raises ``ValueError`` naming the file and
    what it lacks (``ROADMAP.md`` queues them; the other TIFF variants:
    ``tests/test_torch_variants.py``)."""
    what = {"tiff_float_rgb": "floating-point", "tiff_logl": "LogL", "tiff_ycbcr_uncompressed": "uncompressed YCbCr",
            "tiff_old_jpeg": "old-style JPEG", "tiff_logluv": "LogLuv", "tiff_zstd": "Zstandard",
            "pf_colour": "not an image file",
            "avif": "AVIF", "qoi": "QOI", "jpeg_fractional": "sampling factors",
            "jpeg_mcu_of_11_blocks": "11 blocks an MCU", "gif_ends_early": "truncated"}[case]
    data = {
        "tiff_float_rgb": lambda: tiff_file(WIDE, 16, 2, sample_format=3),
        "tiff_logl": lambda: tiff_file(RGB[..., :1], 8, 32844),
        "tiff_ycbcr_uncompressed": lambda: tiff_file(RGB, 8, 6),
        "tiff_old_jpeg": lambda: tiff_file(RGB, 8, 2).replace(struct.pack("<HHIHH", 259, 3, 1, 1, 0),
                                                              struct.pack("<HHIHH", 259, 3, 1, 6, 0)),
        "tiff_logluv": lambda: tiff_file(RGB, 8, 32845),
        "tiff_zstd": lambda: pillow(Image.fromarray(RGB), "TIFF", compression="zstd"),
        "pf_colour": lambda: b"PF\n1 1\n-1.0\n" + bytes(12),
        "avif": lambda: pillow(Image.fromarray(RGB), "AVIF"),
        "qoi": lambda: pillow(Image.fromarray(RGB), "QOI"),
        "jpeg_fractional": lambda: jpeg_sampled([_Y, _CB, _CR], ((3, 2), (2, 1), (1, 1))),
        "jpeg_mcu_of_11_blocks": lambda: jpeg_sampled([_Y, _CB, _CR], ((3, 3), (1, 1), (1, 1))),
        # an End code 40 pixels into a 91-pixel frame: Pillow raises too
        "gif_ends_early": lambda: gif_file(_IDX16, _gif_table(16), min_size=4, coded=40),
    }[case]
    path = tmp_path / f"{case}.img"
    path.write_bytes(data())
    with pytest.raises(ValueError, match=what) as err:
        tenv.load_image(path)
    assert str(path) in str(err.value)


# --- writing ---

WRITE_EXTS = [".tif", ".tiff", ".TIF", ".bmp", ".dib", ".ppm", ".pnm", ".pgm", ".pbm", ".PFM", ".tga", ".icb",
              ".vda", ".vst", ".gif", ".GIF", ".apng"]


@pytest.mark.parametrize("ext", WRITE_EXTS)
def test_save_image_matches_pillow(tmp_path, ext):
    """``envmap.save_image`` and ``film.save_png`` write Pillow's file for
    the same pixels, byte for byte (``.apng``: the port's PNG, which
    decodes to them); a 48x64 image (GIF: interlaced, optimised palette)."""
    img = np.random.default_rng(len(ext)).uniform(-0.1, 1.1, (48, 64, 3)).astype(np.float32)
    img[:20] = np.round(img[:20] * 4) / 4  # some flat colours, some noise
    tenv.save_image(tmp_path / f"t{ext}", img)
    jenv.save_image(tmp_path / f"j{ext}", img)
    got, want = (tmp_path / f"t{ext}").read_bytes(), (tmp_path / f"j{ext}").read_bytes()
    rgb8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    if ext == ".apng":
        assert got == imageio.encode_png(rgb8)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(got)).convert("RGB")), rgb8)
    else:
        assert got == want
    np.testing.assert_array_equal(tenv.load_image(tmp_path / f"t{ext}"), jenv.load_image(tmp_path / f"j{ext}"))
    film = np.concatenate([img[::-1], np.ones((48, 64, 1), np.float32)], axis=-1)
    import torch

    tfilm.save_png(tmp_path / f"f{ext}", torch.from_numpy(film))
    srgb = (np.clip(tfilm.film_to_srgb(torch.from_numpy(film)).numpy() * 255.0, 0, 255).astype(np.uint8))[::-1]
    assert (tmp_path / f"f{ext}").read_bytes() == imageio._ENCODERS[imageio.image_format(f"f{ext}")](srgb)


@pytest.mark.parametrize("case", ["gif_one_colour", "gif_two_colours", "gif_many_colours", "gif_sky"])
def test_gif_writer_matches_pillow(case):
    """The GIF writer against Pillow's file: bytes equal, and the decodes
    pixel-equal (one colour, two, more than 65,536: the quantizer's
    scaled colour hash, the dragon sky's 512x256 crop)."""
    rng = np.random.default_rng(11)
    px = {"gif_one_colour": lambda: np.full((7, 9, 3), 77, np.uint8),
          "gif_two_colours": lambda: np.where(rng.random((17, 16, 1)) < 0.5, [1, 2, 3], [200, 100, 50]).astype(np.uint8),
          "gif_many_colours": lambda: rng.integers(0, 256, (300, 300, 3), dtype=np.uint8),
          "gif_sky": lambda: np.asarray(Image.open(os.path.join(REPO, "assets", "sky.png")).convert("RGB"))}[case]()
    if native._load() is None:
        pytest.skip("no g++: the native library is not built")
    got, want = gif.encode_gif(px), pillow(Image.fromarray(px), "GIF")
    assert got == want
    np.testing.assert_array_equal(gif.decode_gif(got), np.asarray(Image.open(io.BytesIO(want)).convert("RGB")))


# --- native against the Python twins ---


def _native_cases():
    rng = np.random.default_rng(21)
    big = pixels(64, 96, 22)
    lzw_tif = pillow(Image.fromarray(big), "TIFF", compression="tiff_lzw")
    strips = tiff._ifd(lzw_tif, "x")[1]
    lzw = lzw_tif[strips[273][0]:strips[273][0] + strips[279][0]]
    raw = np.repeat(big.reshape(-1), rng.integers(1, 4, big.size)).tobytes()[:5000]
    gif_codes = gif._lzw_encode_py(np.asarray(_pal_img(big, 200)), 8)
    lzw_bad = lzw[:20] + bytes(rng.integers(0, 256, 50, dtype=np.uint8))
    gif_bad = gif_codes[:30] + bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    full, low = rng.integers(0, 256, 20000).astype(np.uint8), rng.integers(0, 8, 3000).astype(np.uint8)
    noise = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    few = (rng.integers(0, 3, (20, 30, 3)) * 100).astype(np.uint8)
    return {
        "tiff_lzw": lambda m: m(lzw, big.size),
        "tiff_lzw_short": lambda m: m(lzw[:len(lzw) // 2], big.size),
        "tiff_lzw_corrupt": lambda m: m(lzw_bad, big.size),
        "packbits": lambda m: m(packbits(raw), len(raw)),
        "packbits_cut": lambda m: m(packbits(raw)[:-7] + b"\x90", len(raw)),
        "gif_lzw_decode": lambda m: m(gif_codes, 8, 64 * 96),
        "gif_lzw_decode_min2": lambda m: m(gif._lzw_encode_py(_IDX_GRAY, 2), 2, _IDX_GRAY.size),
        "gif_lzw_decode_short": lambda m: m(gif_codes[:len(gif_codes) // 3], 8, 64 * 96),
        "gif_lzw_decode_corrupt": lambda m: m(gif_bad, 8, 64 * 96),
        "gif_lzw_encode": lambda m: m(np.asarray(_pal_img(big, 200)), 8),
        "gif_lzw_encode_table_full": lambda m: m(full, 8),
        "gif_lzw_encode_min3": lambda m: m(low, 3),
        "tga_rle": lambda m: m(tga_rle(big.reshape(64, 96, 3)), 3, 96 * 3, 64),
        "tga_rle_crossing": lambda m: m(bytes([0x85, 1, 2, 3]), 3, 9, 2),
        "bmp_rle8": lambda m: m(rle8(_IDX256.astype(np.uint8)), 54, 14, False, 14 * 9),
        "bmp_rle8_delta_odd_base": lambda m: m(_delta_body(_IDX256), 55, 14, False, 14 * 9),
        "bmp_rle4": lambda m: m(_rle4_body(_IDX16), 118, 13, True, 13 * 7),
        "bmp_rle_cut_delta": lambda m: m(bytes([0, 2, 5]), 54, 14, False, 14 * 9),
        "quantize_smooth": lambda m: m(big),
        "quantize_noise": lambda m: m(noise),
        "quantize_few": lambda m: m(few),
    }


NATIVE = {"tiff_lzw": ("tiff_lzw_decode", tiff._lzw_decode_py), "packbits": ("packbits_decode", tiff._packbits_decode_py),
          "gif_lzw_decode": ("gif_lzw_decode", gif._lzw_decode_py), "gif_lzw_encode": ("gif_lzw_encode", gif._lzw_encode_py),
          "tga_rle": ("tga_rle_decode", tga._rle_decode_py), "bmp_rle": ("bmp_rle_decode", bmp._rle_decode_py),
          "quantize": ("median_cut_quantize", gif._quantize_py)}


@pytest.mark.parametrize("case", ["tiff_lzw", "tiff_lzw_short", "tiff_lzw_corrupt", "packbits", "packbits_cut",
                                  "gif_lzw_decode", "gif_lzw_decode_min2", "gif_lzw_decode_short",
                                  "gif_lzw_decode_corrupt", "gif_lzw_encode", "gif_lzw_encode_table_full",
                                  "gif_lzw_encode_min3", "tga_rle", "tga_rle_crossing", "bmp_rle8",
                                  "bmp_rle8_delta_odd_base", "bmp_rle4", "bmp_rle_cut_delta", "quantize_smooth",
                                  "quantize_noise", "quantize_few"])
def test_native_matches_python(case):
    """Each native loop (``csrc/pt_native.cpp``) against its Python twin:
    the same output and return code, corrupt and cut-off input included."""
    if native._load() is None:
        pytest.skip("no g++: the native library is not built")
    run = _native_cases()[case]
    name, twin = next(v for k, v in NATIVE.items() if case.startswith(k))
    got, want = run(getattr(native, name)), run(twin)
    if isinstance(want, bytes):
        assert got == want
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("family", ["tiff", "gif", "bmp", "ppm", "tga", "jpeg_cmyk_sampled"])
@pytest.mark.parametrize("impl", ["native", "python"])
def test_corrupt_files_raise_value_error(monkeypatch, family, impl):
    """Files with random bytes overwritten or cut short decode to an image
    or raise ``ValueError`` naming the file: no other exception, and no
    read outside the native loops' buffers."""
    if impl == "native" and native._load() is None:
        pytest.skip("no g++: the native library is not built")
    monkeypatch.setattr(native, "available", (lambda: True) if impl == "native" else (lambda: False))
    small = RGB[:11, :19]
    files = {
        "tiff": [pillow(Image.fromarray(small), "TIFF", compression="tiff_lzw", tiffinfo={317: 2}),
                 pillow(Image.fromarray(small), "TIFF", compression="packbits"),
                 tiff_file(WIDE[:9, :11], 16, 2, order=">", compression=8, tile=(16, 16), predictor=2)],
        "gif": [pillow(Image.fromarray(small), "GIF"),
                gif_file(_IDX16, _gif_table(16), local=True, interlace=True, transparency=3, min_size=4)],
        "bmp": [pillow(Image.fromarray(small), "BMP"), bmp_file(13, 7, 4, _rle4_body(_IDX16), compression=2,
                                                              palette=bmp_palette(_gif_table(16)), colors=16),
                bmp_file(14, 9, 8, _delta_body(_IDX256), compression=1, palette=bmp_palette(_gif_table(256)))],
        "ppm": [pillow(Image.fromarray(small), "PPM"), READ_CASES["ppm_p3_maxval1000"](),
                READ_CASES["ppm_p1_comments"](), READ_CASES["pfm_gray"]()],
        "tga": [pillow(Image.fromarray(small), "TGA", rle=True), READ_CASES["tga_cmap16_rle_raw_across_rows"](),
                pillow(_pal_img(small), "TGA")],
        "jpeg_cmyk_sampled": [pillow(Image.fromarray(_CMYK[:11, :19], "CMYK"), "JPEG"),
                              jpeg_sampled([_Y[:11, :19], _CB[:11, :19], _CR[:11, :19]], ((4, 1), (1, 1), (1, 1)))],
    }[family]
    rng = np.random.default_rng(len(family) + len(impl))
    for i in range(60):
        data = bytearray(files[i % len(files)])
        for j in rng.integers(0, len(data), rng.integers(1, 5)):
            data[j] = rng.integers(0, 256)
        if i % 5 == 0:
            data = data[:rng.integers(2, len(data))]
        try:
            out = imageio.decode_image(bytes(data), "corrupt")
        except ValueError as err:
            assert "corrupt" in str(err)
        else:
            assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3


# --- the committed assets and the TIFF-sky scene ---


def test_format_digests_match_pillow(monkeypatch):
    """``assets/format_digests.json`` holds the SHA-256 of Pillow's
    ``convert("RGB")`` bytes of each committed format file (the card's
    machine, without Pillow, holds the port to them); the port's decode
    matches; each file is under 100 KB and all under 400 KB."""
    monkeypatch.chdir(REPO)
    digests = json.loads(open(DIGESTS).read())
    assert len(digests) == 8 and sum(d["bytes"] for d in digests.values()) < 400_000
    for path, d in digests.items():
        data = open(path, "rb").read()
        assert len(data) == d["bytes"] < 100_000
        want = np.asarray(Image.open(path).convert("RGB"))
        assert list(want.shape) == d["shape"]
        assert hashlib.sha256(want.tobytes()).hexdigest() == d["sha256"]
        got = imageio.decode_image(data, path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == d["sha256"], path
    sky = np.asarray(Image.open("assets/sky.png").convert("RGB"))
    np.testing.assert_array_equal(imageio.decode_image(open("assets/sky.tif", "rb").read()), sky)


def test_tiff_sky_scene_tables(monkeypatch):
    """``assets/asset_scene_tiff.json`` (``asset_scene.json`` under the LZW
    TIFF copy of ``sky.png``): host tables equal to the JAX package's load
    of it and to the port's PNG-sky scene, sky included (both packages on
    their NumPy builders, as ``tests/torch_builders.py`` explains)."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    tiff_scene = os.path.join("assets", "asset_scene_tiff.json")
    tsh = tconfig.load_scene_json(tiff_scene)
    assert tsh.num_world_tris == 13832 and tsh.env.shape == (256, 512, 3)
    _assert_scenes_equal(jconfig.load_scene_json(tiff_scene), tsh)
    png = tconfig.load_scene_json(os.path.join("assets", "asset_scene.json"))
    _assert_scenes_equal(png, tsh)


@pytest.mark.parametrize("ext", [".tif", ".bmp", ".dib", ".ppm", ".tga", ".gif", ".apng"])
def test_cli_out_new_extensions(tmp_path, ext):
    """``--out`` with each new extension writes the film's tonemapped bytes
    in Pillow's file for them (8x8, one sample)."""
    out = tmp_path / f"x{ext}"
    res = cli.main(["--scene", "env_sphere_scene", "--width", "8", "--height", "8", "--spp", "1",
                    "--max-bounces", "2", "--device", "cpu", "--out", str(out)])
    rgb8 = np.clip(tfilm.film_to_srgb(res["film"]).numpy() * 255.0, 0, 255).astype(np.uint8)[::-1]
    data = out.read_bytes()
    if ext == ".apng":
        assert data == imageio.encode_png(np.ascontiguousarray(rgb8))
    else:
        assert data == pillow(Image.fromarray(np.ascontiguousarray(rgb8)), Image.registered_extensions()[ext])
    if ext != ".gif":
        np.testing.assert_array_equal(imageio.decode_image(data), rgb8)


if __name__ == "__main__":
    write_assets()
    for rel, d in json.loads(open(os.path.join(REPO, DIGESTS)).read()).items():
        print(rel, d["shape"], d["bytes"])
