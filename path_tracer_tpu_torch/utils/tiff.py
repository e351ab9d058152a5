"""TIFF, read and written without Pillow, to Pillow's bytes.

* `decode_tiff`: the first image file directory, as
  ``Image.open(...).convert("RGB")`` shows it: byte orders ``II`` and
  ``MM``; strips and tiles; compression 1 (none), 5 (LZW), 8 and 32946
  (Deflate) and 32773 (PackBits); predictor 2 at 8 and 16 bits; planar
  configuration 1 and 2; photometric 0 and 1 (gray at 1, 2, 4, 8 and 16
  bits, with or without alpha), 2 (RGB at 8 and 16 bits, an extra sample
  dropped: unassociated alpha as it is, associated alpha divided out as
  Pillow's ``RGBa`` unpacker divides it) and 3 (palette; the 16-bit colour
  map by its high byte). Gray below 8 bits is scaled to 0..255 (2^d - 1 to
  255), WhiteIsZero inverted. 16-bit gray keeps its high byte where Pillow
  clips the ``I;16`` value to 255, as for 16-bit gray PNG (``ROADMAP.md``,
  known faults of the reference). JPEG-in-TIFF, float samples, CMYK,
  YCbCr, CIELab and LogLuv raise ``ValueError``, naming the file.
* `encode_tiff`: the file ``Image.fromarray(rgb8, "RGB").save(path)`` writes
  for a ``.tif`` / ``.tiff``: uncompressed, little-endian, one strip.

The LZW and PackBits loops run in `native` (host C++) where g++ built it,
else in the Python twins here, which give the same output.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from path_tracer_tpu_torch import native

SIGNATURES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I"}
_COMPRESSION = {1: "raw", 5: "lzw", 8: "deflate", 32946: "deflate", 32773: "packbits"}
_COMPRESSION_NAMES = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 6: "old-style JPEG",
                      7: "JPEG", 34712: "JPEG 2000", 34925: "LZMA", 50000: "Zstandard",
                      50001: "WebP", 32809: "ThunderScan", 32946: "Deflate"}
_PHOTOMETRIC_NAMES = {4: "transparency mask", 5: "CMYK", 6: "YCbCr", 8: "CIELab", 9: "ICCLab",
                      10: "ITULab", 32844: "LogL", 32845: "LogLuv"}


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
    """The byte order and the first IFD's tags: ``{tag: tuple of values}``."""
    if data[:4] not in SIGNATURES:
        raise ValueError(f"{name}: not a TIFF file")
    if data[2] == 0x2B or data[3] == 0x2B:
        raise ValueError(f"{name}: BigTIFF is not supported (classic TIFF only)")
    e = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise ValueError(f"{name}: TIFF header is truncated")
    (off,) = struct.unpack(e + "I", data[4:8])
    if off + 2 > len(data):
        raise ValueError(f"{name}: TIFF directory offset past the end of the file")
    (n,) = struct.unpack(e + "H", data[off:off + 2])
    tags = {}
    for i in range(n):
        p = off + 2 + 12 * i
        if p + 12 > len(data):
            raise ValueError(f"{name}: TIFF directory is truncated")
        tag, typ, count = struct.unpack(e + "HHI", data[p:p + 8])
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize(e + fmt) * count
        at = p + 8 if size <= 4 else struct.unpack(e + "I", data[p + 8:p + 12])[0]
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


def _blocks(data, e, tags, w, h, spp_block, bits, compression, predictor, name):
    """The decoded bytes of every strip or tile as ``(x, y, bw, bh, rows
    [bh, row bytes])``, in file order."""
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
    row_bytes = (bw * bits * spp_block + 7) // 8
    across = -(-w // bw)
    per_plane = across * -(-h // bh)
    for i, off in enumerate(offsets):
        k = i % per_plane
        x, y = (k % across) * bw, (k // across) * bh
        if y >= h:
            continue
        rows_here = bh if tiled else min(bh, h - y)
        need = rows_here * row_bytes
        if compression == "raw":
            raw = data[off:off + need]
        else:
            n = counts[i] if counts and i < len(counts) else len(data) - off
            chunk = data[off:off + n]
            if compression == "lzw":
                if chunk[:1] == b"\x00" and len(chunk) > 1 and chunk[1] & 1:
                    raise ValueError(f"{name}: old-style (LSB-first) TIFF LZW is not supported")
                raw, rc = _lzw_decode(chunk, need)
                if rc:
                    raise ValueError(f"{name}: corrupt TIFF LZW data")
            elif compression == "packbits":
                raw = _packbits_decode(chunk, need)
            else:
                try:
                    raw = zlib.decompressobj().decompress(chunk, need)
                except zlib.error as err:
                    raise ValueError(f"{name}: bad TIFF Deflate data ({err})") from None
        if len(raw) < need:
            raise ValueError(f"{name}: TIFF image data is truncated")
        rows = np.frombuffer(raw[:need], np.uint8).reshape(rows_here, row_bytes)
        if predictor == 2:
            rows = _unpredict(rows, spp_block, bits, e, name)
        elif predictor != 1:
            raise ValueError(f"{name}: TIFF predictor {predictor} is not supported")
        yield i // per_plane, x, y, bw, rows


def _samples(rows: np.ndarray, bw: int, spp: int, bits: int, e: str) -> np.ndarray:
    """Rows of packed samples -> ``[h, bw, spp]`` sample values (uint8
    below 16 bits, uint16 at 16)."""
    h = rows.shape[0]
    if bits == 8:
        return rows.reshape(h, -1, spp)[:, :bw]
    if bits == 16:
        return rows.view(e + "u2").reshape(h, -1, spp)[:, :bw].astype(np.uint16)
    vals = np.unpackbits(rows, axis=1).reshape(h, -1, bits) @ (1 << np.arange(bits - 1, -1, -1))
    return vals[:, :bw * spp].reshape(h, bw, spp).astype(np.uint8)


def decode_tiff(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A TIFF file's bytes -> uint8 RGB ``[H, W, 3]``, Pillow's
    ``Image.open(...).convert("RGB")`` of the first image but for 16-bit
    gray (the high byte, where Pillow clips). Raises ``ValueError`` naming
    ``name`` and what it lacks."""
    e, tags = _ifd(data, name)
    if 256 not in tags or 257 not in tags:
        raise ValueError(f"{name}: TIFF without an image width and length")
    w, h = _one(tags, 256, 0), _one(tags, 257, 0)
    if w <= 0 or h <= 0 or w * h > 2 * 89478485:
        raise ValueError(f"{name}: bad TIFF image size {w}x{h}")
    code = _one(tags, 259, 1)
    if code not in _COMPRESSION:
        raise ValueError(f"{name}: {_COMPRESSION_NAMES.get(code, f'compression {code}')} TIFF "
                         "is not supported (none, LZW, Deflate and PackBits are)")
    compression = _COMPRESSION[code]
    photo = _one(tags, 262, 0)
    if photo not in (0, 1, 2, 3):
        raise ValueError(f"{name}: {_PHOTOMETRIC_NAMES.get(photo, f'photometric {photo}')} TIFF "
                         "is not supported (gray, RGB and palette are)")
    if _one(tags, 266, 1) != 1:
        raise ValueError(f"{name}: TIFF fill order 2 is not supported")
    if _one(tags, 274, 1) in (5, 6, 7, 8):
        raise ValueError(f"{name}: transposed TIFF orientation is not supported")
    fmt = tags.get(339, (1,))
    extra = tags.get(338, ())
    spp = _one(tags, 277, 1)
    bps = tags.get(258, (1,))
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    bits = bps[0] if bps else 0
    if 3 in fmt:
        raise ValueError(f"{name}: floating-point TIFF samples are not supported")
    if len(bps) != spp or any(b != bits for b in bps):
        raise ValueError(f"{name}: TIFF samples of {bps} bits are not supported")
    base = 3 if photo == 2 else 1
    ok = {0: {(1,): (1, 2, 4, 8, 16), (2,): (8,)}, 1: {(1,): (1, 2, 4, 8, 16), (2,): (8,)},
          2: {(1,): (8, 16)}, 3: {(1,): (1, 2, 4, 8)}}[photo]
    if len(set(fmt)) == 1 and len(fmt) > 1:
        fmt = fmt[:1]
    if spp != base + len(extra) or fmt not in ok or bits not in ok[fmt]:
        raise ValueError(f"{name}: TIFF with photometric {photo}, {spp} samples of {bits} bits, "
                         f"sample format {fmt} and extra samples {extra} is not supported")
    if extra and not (len(extra) <= 3 and extra[0] in (0, 1, 2, 999) and all(x == 0 for x in extra[1:])
                      and bits in (8, 16) and (photo == 2 or (photo in (0, 1) and extra == (2,)
                                                              and bits == 8))):
        raise ValueError(f"{name}: TIFF extra samples {extra} are not supported")
    planar = _one(tags, 284, 1)
    if planar not in (1, 2):
        raise ValueError(f"{name}: TIFF planar configuration {planar} is not supported")
    # libtiff applies the predictor in its LZW and Deflate codecs only
    predictor = _one(tags, 317, 1) if compression in ("lzw", "deflate") else 1
    planes = spp if planar == 2 and spp > 1 else 1
    img = np.zeros((h, w, spp), np.uint16 if bits == 16 else np.uint8)
    for plane, x, y, bw, rows in _blocks(data, e, tags, w, h, spp // planes, bits,
                                         compression, predictor, name):
        if plane >= planes:
            continue
        s = _samples(rows, bw, spp // planes, bits, e)
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
    if photo in (0, 1):
        g = img[..., 0]
        if bits == 16:
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
