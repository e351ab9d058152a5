"""TIFF, read and written without Pillow, to Pillow's bytes.

* `decode_tiff`: the first image file directory, as
  ``Image.open(...).convert("RGB")`` shows it: byte orders ``II`` and
  ``MM``, classic TIFF and BigTIFF; strips and tiles; compression 1
  (none), 5 (LZW), 8 and 32946 (Deflate), 32773 (PackBits), 34925 (LZMA),
  7 (JPEG, through `imageio.decode_jpeg` after the JPEGTables stream, in
  the colour space libtiff imposes) and 2, 3 and 4 (CCITT, `ccitt`);
  predictor 2 at 8 and 16 bits; planar configuration 1 and 2; fill order
  2 where Pillow has a mode for it (bits reversed in each byte of the
  data, JPEG excepted, as libtiff does); photometric 0 and 1 (gray at 1,
  2, 4, 8 and 16 bits, with or without alpha; signed 8, 16 and 32-bit,
  unsigned 32-bit and float32 gray, Pillow's modes ``I`` and ``F`` clipped
  to 0..255 (float truncated, NaN 0)), 2 (RGB at 8 and 16 bits, an extra
  sample dropped: unassociated alpha as it is, associated alpha divided
  out as Pillow's ``RGBa`` unpacker divides it), 3 (palette; the 16-bit
  colour map by its high byte), 5 (CMYK at 8 and 16 bits, Pillow's CMYK ->
  RGB), 6 (YCbCr, subsampled, through libtiff's ``TIFFYCbCrToRGB``
  integer tables as Pillow's RGBA read uses them; JPEG's through
  libjpeg's) and 8 (CIELab at 8 bits, through `lcms_lab`, Pillow's
  LittleCMS transform); then the Orientation tag applied as Pillow's load applies it
  (flips for 2-4, transposes for 5-8). Gray below 8 bits is scaled to
  0..255 (2^d - 1 to 255), WhiteIsZero inverted. 16-bit gray keeps its high
  byte where Pillow clips the ``I;16`` value to 255, as for 16-bit gray PNG
  (``ROADMAP.md``, known faults of the reference); signed 16-bit gray too,
  negatives at 0. Pillow reads a big-endian signed or float sample that
  libtiff decompressed in little-endian order; so does the port.
  Zstandard, old-style JPEG and LogLuv files and RGB floats raise
  ``ValueError``, naming the file.
* `encode_tiff`: the file ``Image.fromarray(rgb8, "RGB").save(path)`` writes
  for a ``.tif`` / ``.tiff``: uncompressed, little-endian, one strip.

The LZW, PackBits and CCITT loops run in `native` (host C++) where g++
built it, else in the Python twins here and in `ccitt`, which give the
same output.
"""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from path_tracer_tpu_torch import native
from path_tracer_tpu_torch.utils import ccitt, lcms_lab

SIGNATURES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
_COMPRESSION = {1: "raw", 5: "lzw", 8: "deflate", 32946: "deflate", 32773: "packbits", 34925: "lzma",
                7: "jpeg", 2: "ccitt", 3: "ccitt", 4: "ccitt"}
_COMPRESSION_NAMES = {6: "old-style JPEG", 34712: "JPEG 2000", 50000: "Zstandard", 50001: "WebP",
                      32809: "ThunderScan", 32771: "CCITT RLE word-aligned", 34676: "SGI LogL",
                      34677: "SGI LogLuv"}
_PHOTOMETRIC_NAMES = {4: "transparency mask", 9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}
# the tags read as integers (sizes, codes, offsets, counts, options)
_INT_TAGS = (256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 292, 293, 317, 320, 322, 323, 324,
             325, 338, 339, 347, 530)
_BITREV = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
# Orientation (274) as Pillow's ImageOps.exif_transpose applies it, on [h, w, c]
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.transpose(1, 0, 2), 6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
           7: lambda a: a[::-1, ::-1].transpose(1, 0, 2), 8: lambda a: a.transpose(1, 0, 2)[::-1]}


# --- LZW and PackBits, Python twins of native.tiff_lzw_decode / packbits_decode ---


def _lzw_decode_py(data: bytes, size: int) -> tuple[bytes, int]:
    """MSB-first codes of 9 to 12 bits, early change (libtiff's LZWDecode)
    -> (at most ``size`` bytes, 0), or (b"", -1) for a corrupt table."""
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    bits, total = int.from_bytes(data, "big"), len(data) * 8
    pos, width, old = 0, 9, None  # old: None before any Clear, -2 just after one
    while len(out) < size and pos + width <= total:
        code = (bits >> (total - pos - width)) & ((1 << width) - 1)
        pos += width
        if code == 257:
            break
        if code == 256:
            table, width, old = table[:258], 9, -2
            continue
        if old is None:
            return b"", -1
        if old == -2:
            if code > 256:
                return b"", -1
            out.append(code)
            old = code
            continue
        nxt = len(table)
        if code > nxt or nxt >= 4096 + 1024:
            return b"", -1
        table.append(table[old] + (table[code][:1] if code < nxt else table[old][:1]))
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
        out += table[code]
        old = code
    return bytes(out[:size]), 0


def _packbits_decode_py(data: bytes, size: int) -> bytes:
    """PackBits: a header n >= 0 copies n + 1 bytes, -127..-1 repeats the
    next byte 1 - n times, -128 is skipped."""
    out, i = bytearray(), 0
    while i < len(data) and len(out) < size:
        h = data[i] - 256 if data[i] > 127 else data[i]
        i += 1
        if h >= 0:
            out += data[i:i + h + 1]
            i += h + 1
        elif h != -128:
            if i >= len(data):
                break
            out += data[i:i + 1] * (1 - h)
            i += 1
    return bytes(out[:size])


def _lzw_decode(data, size):
    if native.available():
        return native.tiff_lzw_decode(data, size)
    return _lzw_decode_py(data, size)


def _packbits_decode(data, size):
    if native.available():
        return native.packbits_decode(data, size)
    return _packbits_decode_py(data, size)


# --- read ---


def _ifd(data: bytes, name: str) -> tuple[str, dict]:
    """The byte order and the first IFD's tags: ``{tag: tuple of values}``
    (classic TIFF, or BigTIFF: 8-byte offsets, 20-byte entries)."""
    if data[:4] not in SIGNATURES:
        raise ValueError(f"{name}: not a TIFF file")
    e = "<" if data[:2] == b"II" else ">"
    if data[:4] == b"MM\x00\x2b":
        raise ValueError(f"{name}: big-endian BigTIFF; Pillow 12.1.0 does not read it either (its header "
                         "check looks for 43 in byte 2)")
    big = data[2] == 0x2B
    if len(data) < (16 if big else 8):
        raise ValueError(f"{name}: TIFF header is truncated")
    if big:
        size, zero, off = struct.unpack(e + "HHQ", data[4:16])
        if size != 8 or zero != 0:
            raise ValueError(f"{name}: bad BigTIFF header (offset size {size})")
        cfmt, efmt, entry, inline = "Q", "HHQ", 20, 8
    else:
        (off,) = struct.unpack(e + "I", data[4:8])
        cfmt, efmt, entry, inline = "H", "HHI", 12, 4
    csize = struct.calcsize(cfmt)
    if off + csize > len(data):
        raise ValueError(f"{name}: TIFF directory offset past the end of the file")
    (n,) = struct.unpack(e + cfmt, data[off:off + csize])
    tags = {}
    for i in range(n):
        p = off + csize + entry * i
        if p + entry > len(data):
            raise ValueError(f"{name}: TIFF directory is truncated")
        tag, typ, count = struct.unpack(e + efmt, data[p:p + entry - inline])
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize(e + fmt) * count
        at = p + entry - inline
        if size > inline:
            (at,) = struct.unpack(e + ("Q" if big else "I"), data[at:at + inline])
        if at + size > len(data):
            raise ValueError(f"{name}: TIFF tag {tag} points past the end of the file")
        vals = struct.unpack(e + fmt * count, data[at:at + size])
        if typ in (5, 10):
            vals = tuple(a / b if b else 0.0 for a, b in zip(vals[0::2], vals[1::2]))
        tags[tag] = vals
    return e, tags


def _one(tags, tag, default):
    v = tags.get(tag)
    return v[0] if v else default


def _unpredict(rows: np.ndarray, spp: int, bits: int, e: str, name: str) -> np.ndarray:
    """Undo predictor 2 (horizontal differencing) on ``rows [h, bytes]`` of
    ``spp`` samples a pixel."""
    if bits == 8:
        h = rows.shape[0]
        px = rows.reshape(h, -1, spp).astype(np.uint8)
        return np.cumsum(px, axis=1, dtype=np.uint8).reshape(h, -1)
    if bits == 16:
        h = rows.shape[0]
        px = rows.view(e + "u2").reshape(h, -1, spp)
        return np.cumsum(px, axis=1, dtype=np.uint16).astype(e + "u2").view(np.uint8).reshape(h, -1)
    raise ValueError(f"{name}: TIFF predictor 2 at {bits}-bit samples is not supported")


def _ccitt_decode(*args):
    if native.available():
        return native.ccitt_decode(*args, ccitt.WHITE_LUT, ccitt.BLACK_LUT)
    return ccitt.decode_py(*args)


def _blocks(data, tags, w, h, size, compression, fill, name):
    """The decompressed bytes of every strip or tile as ``(plane, x, y,
    block width, rows, bytes)``, in file order; ``size(bw, rows)`` the bytes
    a block of that size holds. Fill order 2 reverses the bits of each byte
    first (libtiff: every codec but JPEG)."""
    tiled = 322 in tags
    if tiled:
        bw, bh = _one(tags, 322, 0), _one(tags, 323, 0)
        offsets, counts = tags.get(324, ()), tags.get(325)
        if bw <= 0 or bh <= 0:
            raise ValueError(f"{name}: bad TIFF tile size {bw}x{bh}")
    else:
        bw, bh = w, min(_one(tags, 278, h) or h, h)
        offsets, counts = tags.get(273, ()), tags.get(279)
    if not offsets:
        raise ValueError(f"{name}: TIFF without strip or tile offsets")
    across = -(-w // bw)
    per_plane = across * -(-h // bh)
    for i, off in enumerate(offsets):
        k = i % per_plane
        x, y = (k % across) * bw, (k // across) * bh
        if y >= h:
            continue
        rows_here = bh if tiled else min(bh, h - y)
        need = size(bw, rows_here)
        if compression == "raw":
            raw = data[off:off + need]
            if fill == 2:
                raw = raw.translate(_BITREV)
        else:
            n = counts[i] if counts and i < len(counts) else len(data) - off
            chunk = data[off:off + n]
            if fill == 2 and compression != "jpeg":
                chunk = chunk.translate(_BITREV)
            if compression == "jpeg":
                raw = chunk
            elif compression == "lzw":
                if chunk[:1] == b"\x00" and len(chunk) > 1 and chunk[1] & 1:
                    raise ValueError(f"{name}: old-style (LSB-first) TIFF LZW is not supported")
                raw, rc = _lzw_decode(chunk, need)
                if rc:
                    raise ValueError(f"{name}: corrupt TIFF LZW data")
            elif compression == "packbits":
                raw = _packbits_decode(chunk, need)
            elif compression == "lzma":
                try:
                    raw = lzma.LZMADecompressor(format=lzma.FORMAT_XZ).decompress(chunk, need)
                except lzma.LZMAError as err:
                    raise ValueError(f"{name}: bad TIFF LZMA data ({err})") from None
            elif compression == "ccitt":
                code = _one(tags, 259, 1)
                options = _one(tags, 292 if code == 3 else 293, 0)
                raw, rc = _ccitt_decode(chunk, bw, rows_here, code, options)
                if rc:
                    raise ValueError(f"{name}: {ccitt.ERRORS[rc]}")
            else:
                try:
                    raw = zlib.decompressobj().decompress(chunk, need)
                except zlib.error as err:
                    raise ValueError(f"{name}: bad TIFF Deflate data ({err})") from None
        if compression != "jpeg" and len(raw) < need:
            raise ValueError(f"{name}: TIFF image data is truncated")
        yield i // per_plane, x, y, bw, rows_here, raw


def _samples(rows: np.ndarray, bw: int, spp: int, bits: int, e: str) -> np.ndarray:
    """Rows of packed samples -> ``[h, bw, spp]`` sample values (uint8
    below 16 bits, uint16 at 16, uint32 at 32)."""
    h = rows.shape[0]
    if bits == 8:
        return rows.reshape(h, -1, spp)[:, :bw]
    if bits in (16, 32):
        return rows.view(e + f"u{bits // 8}").reshape(h, -1, spp)[:, :bw].astype(f"u{bits // 8}")
    vals = np.unpackbits(rows, axis=1).reshape(h, -1, bits) @ (1 << np.arange(bits - 1, -1, -1))
    return vals[:, :bw * spp].reshape(h, bw, spp).astype(np.uint8)


def _ycbcr_tables(tags):
    """tif_color.c TIFFYCbCrToRGBInit in float32 as C computes it: the Y,
    Cr->R, Cb->B, Cr->G and Cb->G tables (256 each)."""
    f32 = np.float32
    luma = [f32(v) for v in tags.get(529, (0.299, 0.587, 0.114))[:3]]
    rbw = [f32(v) for v in tags.get(532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))[:6]]

    def fix(v):  # FIX(CLAMP(f, 0, 2)) at SHIFT 16
        return int(float(f32(min(max(v, f32(0)), f32(2))) * f32(65536)) + 0.5)

    f1 = f32(2) - f32(2) * luma[0]
    f2 = luma[0] * f1 / luma[1]
    f3 = f32(2) - f32(2) * luma[2]
    f4 = luma[2] * f3 / luma[1]
    d1, d2, d3, d4 = fix(f1), -fix(f2), fix(f3), -fix(f4)

    def code2v(c, rb, rw, cr):  # ((c - (int)RB) * (float)CR) / (float)(RW - RB, or 1)
        den = rw - rb
        return f32(f32(c - int(rb)) * f32(cr)) / (den if den != 0 else f32(1))

    def clampw(v):
        return int(min(max(v, f32(-128 * 32)), f32(128 * 32)))  # (int32) truncation

    y_tab, cr_r, cb_b, cr_g, cb_g = ([0] * 256 for _ in range(5))
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127))
        cb = clampw(code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127))
        cr_r[i] = (d1 * cr + 32768) >> 16
        cb_b[i] = (d3 * cb + 32768) >> 16
        cr_g[i] = d2 * cr
        cb_g[i] = d4 * cb + 32768
        y_tab[i] = clampw(code2v(x + 128, rbw[0], rbw[1], 255))
    return [np.array(t, np.int64) for t in (y_tab, cr_r, cb_b, cr_g, cb_g)]


def _ycbcr_to_rgb(raw: bytes, bw: int, rows: int, sub, tables) -> np.ndarray:
    """One strip or tile of subsampled 8-bit YCbCr data units (``sub``
    Y samples, then Cb and Cr) -> RGB ``[rows, bw, 3]``, each pixel with its
    unit's chroma (libtiff's putcontig8bitYCbCr*tile through
    TIFFYCbCrtoRGB)."""
    sh, sv = sub
    bx, by = -(-bw // sh), -(-rows // sv)
    units = np.frombuffer(raw[:bx * by * (sh * sv + 2)], np.uint8).reshape(by, bx, sh * sv + 2).astype(np.int64)
    ys = units[..., :sh * sv].reshape(by, bx, sv, sh).transpose(0, 2, 1, 3).reshape(by * sv, bx * sh)[:rows, :bw]
    cb = np.repeat(np.repeat(units[..., sh * sv], sv, 0), sh, 1)[:rows, :bw]
    cr = np.repeat(np.repeat(units[..., sh * sv + 1], sv, 0), sh, 1)[:rows, :bw]
    y_tab, cr_r, cb_b, cr_g, cb_g = tables
    yv = y_tab[ys]
    r = yv + cr_r[cr]
    g = yv + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yv + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _fill_ok(photo, fmt, bps, extra, e, compression) -> bool:
    """Whether Pillow reads fill order 2 here: OPEN_INFO has a mode for it,
    and uncompressed, Pillow has its bit-reversed unpacker (not ``L;IR``,
    ``P;1R``, ``P;2R`` or ``P;4R``; libtiff reverses the others' data)."""
    if fmt != (1,) or extra:
        return False
    if compression == "raw" and ((photo == 0 and bps == (8,)) or (photo == 3 and bps != (8,))):
        return False
    if photo in (0, 1, 3) and bps in ((1,), (2,), (4,), (8,)):
        return True
    return (photo == 1 and bps == (16,) and e == "<") or (photo == 2 and bps == (8, 8, 8))


def decode_tiff(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A TIFF file's bytes -> uint8 RGB ``[H, W, 3]``, Pillow's
    ``Image.open(...).convert("RGB")`` of the first image but for 16-bit
    gray (the high byte, where Pillow clips). Raises ``ValueError`` naming
    ``name`` and what it lacks."""
    from path_tracer_tpu_torch.utils import imageio  # imageio imports this module

    e, tags = _ifd(data, name)
    floats = [t for t in _INT_TAGS if t in tags and not all(isinstance(v, int) for v in tags[t])]
    if floats:
        raise ValueError(f"{name}: TIFF tag {floats[0]} holds fractions where integers belong")
    if 256 not in tags or 257 not in tags:
        raise ValueError(f"{name}: TIFF without an image width and length")
    w, h = _one(tags, 256, 0), _one(tags, 257, 0)
    if w <= 0 or h <= 0 or w * h > 2 * 89478485:
        raise ValueError(f"{name}: bad TIFF image size {w}x{h}")
    code = _one(tags, 259, 1)
    if code not in _COMPRESSION:
        raise ValueError(f"{name}: {_COMPRESSION_NAMES.get(code, f'compression {code}')} TIFF "
                         "is not supported (none, LZW, Deflate, PackBits, LZMA, JPEG and CCITT are)")
    compression = _COMPRESSION[code]
    photo = _one(tags, 262, 0)
    if photo not in (0, 1, 2, 3, 5, 6, 8):
        raise ValueError(f"{name}: {_PHOTOMETRIC_NAMES.get(photo, f'photometric {photo}')} TIFF "
                         "is not supported (gray, RGB, palette, CMYK, YCbCr and CIELab are)")
    fill = _one(tags, 266, 1)
    fmt = tags.get(339, (1,))
    extra = tags.get(338, ())
    spp = _one(tags, 277, 1)
    bps = tags.get(258, (1,))
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    bits = bps[0] if bps else 0
    if len(bps) != spp or any(b != bits for b in bps):
        raise ValueError(f"{name}: TIFF samples of {bps} bits are not supported")
    if len(fmt) > 1 and set(fmt) == {1}:  # Pillow: one format for all bands, uint only
        fmt = fmt[:1]
    if 3 in fmt and photo not in (0, 1):
        raise ValueError(f"{name}: floating-point TIFF samples in colour are not supported "
                         "(Pillow has no mode for them)")
    base = {2: 3, 5: 4, 6: 3, 8: 3}.get(photo, 1)
    ok = {0: {(1,): (1, 2, 4, 8, 16), (2,): (8,), (3,): (32,)},
          1: {(1,): (1, 2, 4, 8, 16) + ((32,) if e == "<" else ()), (2,): (8, 16, 32), (3,): (32,)},
          2: {(1,): (8, 16)}, 3: {(1,): (1, 2, 4, 8)}, 5: {(1,): (8, 16)}, 6: {(1,): (8,)}, 8: {(1,): (8,)}}[photo]
    if spp != base + len(extra) or fmt not in ok or bits not in ok[fmt]:
        raise ValueError(f"{name}: TIFF with photometric {photo}, {spp} samples of {bits} bits, "
                         f"sample format {fmt} and extra samples {extra} is not supported")
    if extra and not (len(extra) <= 3 and extra[0] in (0, 1, 2, 999) and all(x == 0 for x in extra[1:])
                      and bits in (8, 16) and (photo == 2 or (photo in (0, 1) and extra == (2,)
                                                              and bits == 8))):
        if not (photo == 5 and bits == 8 and extra in ((0,), (0, 0))):
            raise ValueError(f"{name}: TIFF extra samples {extra} are not supported")
    if fill not in (1, 2) or (fill == 2 and not _fill_ok(photo, fmt, tuple(bps), extra, e, compression)):
        raise ValueError(f"{name}: TIFF fill order {fill} is not supported here (Pillow has no mode for it)")
    if compression == "ccitt" and (bits != 1 or photo not in (0, 1)):
        raise ValueError(f"{name}: CCITT TIFF of {bits}-bit samples (photometric {photo})")
    planar = _one(tags, 284, 1)
    if planar not in (1, 2):
        raise ValueError(f"{name}: TIFF planar configuration {planar} is not supported")
    orientation = _one(tags, 274, 1)
    if compression == "jpeg":
        rgb = _jpeg_tiff(data, tags, w, h, photo, bits, planar, imageio, name)
    elif photo == 6:
        rgb = _ycbcr_tiff(data, tags, w, h, compression, planar, name)
    else:
        rgb = _sample_tiff(data, e, tags, w, h, photo, spp, bits, fmt, extra, planar, compression, fill,
                           imageio, name)
    return np.ascontiguousarray(_ORIENT[orientation](rgb)) if orientation in _ORIENT else rgb


def _jpeg_tiff(data, tags, w, h, photo, bits, planar, imageio, name):
    """JPEG strips or tiles (compression 7): the JPEGTables stream, then
    each block's, decoded in the colour space libtiff sets (YCbCr -> RGB
    for photometric 6, none for gray, RGB and CMYK)."""
    if photo not in (1, 2, 5, 6) or bits != 8 or planar != 1:
        raise ValueError(f"{name}: JPEG TIFF with photometric {photo}, {bits}-bit samples and planar "
                         f"configuration {planar} is not supported")
    tables = bytes(tags.get(347, b""))
    if tables[-2:] == b"\xff\xd9":
        tables = tables[:-2]
    img = np.zeros((h, w, 3), np.uint8)
    for _, x, y, bw, rows, chunk in _blocks(data, tags, w, h, lambda bw, rows: 0, "jpeg", 1, name):
        stream = tables + chunk[2:] if tables and chunk[:2] == b"\xff\xd8" else tables + chunk
        part = imageio.decode_jpeg(stream, name, colour="ycc" if photo == 6 else "raw")[:h - y, :w - x]
        if part.shape[:2] != (min(rows, h - y), min(bw, w - x)):
            raise ValueError(f"{name}: TIFF JPEG block smaller than its strip or tile")
        img[y:y + part.shape[0], x:x + part.shape[1]] = part
    return img


def _ycbcr_tiff(data, tags, w, h, compression, planar, name):
    """YCbCr strips or tiles, subsampled (YCbCrSubsampling, libtiff's
    default 2x2), as Pillow reads them: through libtiff's RGBA interface."""
    if compression == "raw":
        raise ValueError(f"{name}: uncompressed YCbCr TIFF; Pillow reads it as RGBX and runs out of data")
    sub = tuple(tags.get(530, (2, 2))[:2])
    if planar != 1 or sub[0] not in (1, 2, 4) or sub[1] not in (1, 2, 4) or _one(tags, 317, 1) != 1:
        raise ValueError(f"{name}: YCbCr TIFF with subsampling {sub}, planar configuration {planar} "
                         "or a predictor is not supported")
    tables = _ycbcr_tables(tags)
    img = np.zeros((h, w, 3), np.uint8)

    def size(bw, rows):
        return -(-bw // sub[0]) * -(-rows // sub[1]) * (sub[0] * sub[1] + 2)

    for _, x, y, bw, rows, raw in _blocks(data, tags, w, h, size, compression, 1, name):
        part = _ycbcr_to_rgb(raw, bw, rows, sub, tables)[:h - y, :w - x]
        img[y:y + part.shape[0], x:x + part.shape[1]] = part
    return img


def _sample_tiff(data, e, tags, w, h, photo, spp, bits, fmt, extra, planar, compression, fill, imageio, name):
    """Gray, RGB, palette, CMYK and CIELab samples -> RGB."""
    # libtiff applies the predictor in its LZW, Deflate and LZMA codecs only
    predictor = _one(tags, 317, 1) if compression in ("lzw", "deflate", "lzma") else 1
    planes = spp if planar == 2 and spp > 1 else 1
    spp_block = spp // planes
    # Pillow unpacks what libtiff decompressed (native, little-endian order)
    # with the file's big-endian rawmode for these modes: the bytes swapped
    order = "<" if e == ">" and compression != "raw" and (fmt == (3,) or (fmt == (2,) and bits > 8)) else e
    img = np.zeros((h, w, spp), {16: np.uint16, 32: np.uint32}.get(bits, np.uint8))

    def size(bw, rows):
        return rows * ((bw * bits * spp_block + 7) // 8)

    for plane, x, y, bw, rows_here, raw in _blocks(data, tags, w, h, size, compression, fill, name):
        if plane >= planes:
            continue
        need = size(bw, rows_here)
        rows = np.frombuffer(raw[:need], np.uint8).reshape(rows_here, -1)
        if predictor == 2:
            rows = _unpredict(rows, spp_block, bits, e, name)
        elif predictor != 1:
            raise ValueError(f"{name}: TIFF predictor {predictor} is not supported")
        s = _samples(rows, bw, spp_block, bits, order)
        s = s[:h - y, :w - x]
        if planes == 1:
            img[y:y + s.shape[0], x:x + s.shape[1]] = s
        else:
            img[y:y + s.shape[0], x:x + s.shape[1], plane] = s[..., 0]
    if photo == 3:
        cmap = tags.get(320, ())
        if len(cmap) != 3 << bits:
            raise ValueError(f"{name}: TIFF palette image without a full colour map")
        lut = (np.asarray(cmap, np.int64) // 256).astype(np.uint8).reshape(3, -1).T
        return lut[img[..., 0]]
    if photo == 8:  # Pillow's LAB -> RGB, LittleCMS's transform
        return lcms_lab.lab_to_rgb(img)
    if photo == 5:
        cmyk = (img[..., :4] >> 8) if bits == 16 else img[..., :4]
        return imageio._cmyk_to_rgb(cmyk[..., :3].astype(np.int32), cmyk[..., 3].astype(np.int32))
    if photo in (0, 1):
        g = img[..., 0]
        if fmt == (3,):  # mode F: clipped, truncated, NaN at 0
            f = g.view(np.float32)
            g = np.where(np.isnan(f), 0, np.clip(f, 0, 255)).astype(np.uint8)
        elif bits == 32:  # mode I (int32): clipped
            g = np.clip(g.view(np.int32), 0, 255).astype(np.uint8)
        elif bits == 16 and fmt == (2,):  # the high byte, negatives at 0
            g = (np.maximum(g.view(np.int16), 0) >> 8).astype(np.uint8)
        elif bits == 16:
            g = (g >> 8).astype(np.uint8)  # not inverted at 16 bits, as Pillow's I;16
        else:
            if bits < 8:
                g = (g * (255 // ((1 << bits) - 1))).astype(np.uint8)
            if photo == 0:
                g = 255 - g
        return np.repeat(g[..., None], 3, axis=2)
    rgb = (img[..., :3] >> 8).astype(np.uint8) if bits == 16 else img[..., :3]
    if extra and extra[0] == 1:  # associated alpha: Pillow's RGBa unpacker divides it out
        a = ((img[..., 3] >> 8) if bits == 16 else img[..., 3]).astype(np.int64)[..., None]
        div = np.minimum(rgb.astype(np.int64) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, div)).astype(np.uint8)
    return np.ascontiguousarray(rgb)


# --- write ---


def encode_tiff(rgb8: np.ndarray) -> bytes:
    """8-bit RGB ``[H, W, 3]`` -> the file Pillow writes for
    ``Image.fromarray(rgb8, "RGB").save(path)`` with a ``.tif`` path: one
    IFD of ten tags, BitsPerSample after it, one uncompressed strip."""
    rgb8 = np.ascontiguousarray(rgb8, np.uint8)
    h, w = rgb8.shape[:2]
    entries = ((256, 4, w), (257, 4, h), (258, 3, 134), (259, 3, 1), (262, 3, 2), (273, 4, 140),
               (277, 3, 3), (278, 4, h), (279, 4, 3 * w * h), (284, 3, 1))
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHI", tag, typ, 1 if tag != 258 else 3)
        + (struct.pack("<HH", v, 0) if typ == 3 and tag != 258 else struct.pack("<I", v))
        for tag, typ, v in entries) + struct.pack("<I", 0)
    return b"II*\x00" + struct.pack("<I", 8) + ifd + struct.pack("<HHH", 8, 8, 8) + rgb8.tobytes()
