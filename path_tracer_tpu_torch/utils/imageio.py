"""Image file bytes, read and written without Pillow: PNG and JPEG here,
TIFF, GIF, BMP/DIB, the PPM family, TGA and WebP in the modules beside this
one (`tiff`, `gif`, `bmp`, `netpbm`, `tga`, `webp` with its bitstreams
`vp8` and `vp8l`), and the format dispatch.

The JAX package reads and writes images through Pillow (``Image.open(...)
.convert("RGB")``; ``Image.save(path)``, whose format follows the
extension), which the card's machine does not have. These modules give the
same bytes with ``numpy``, ``zlib`` and ``struct``, and the port's host
library (`native`) for the byte loops (the JPEG entropy coder, LZW,
run lengths, GIF's quantizer, WebP's decode and encode loops):

* `decode_png`: every colour type at every bit depth it allows (1, 2, 4, 8,
  16), Adam7 interlace, every filter type, to the bytes of Pillow's
  ``convert("RGB")``: palette entries expanded (an index past the PLTE
  chunk is black), gray replicated (1/2/4-bit gray scaled by
  255 / (2^d - 1)), alpha and ``tRNS`` dropped, 16-bit samples by their
  high byte. Pillow clips 16-bit gray (mode ``I;16``) to 255 instead; the
  port takes the high byte there too (``ROADMAP.md``, known faults of the
  reference).
* `decode_jpeg`: baseline and extended sequential Huffman (SOF0/SOF1) and
  progressive (SOF2) files; gray, YCbCr, RGB (Adobe transform 0 or the
  component ids ``RGB``), CMYK and YCCK (Adobe transform 2), the 4-component
  ones read as Pillow reads them (``CMYK;I``, then its CMYK -> RGB); every
  sampling libjpeg-turbo takes (1 to 4 per axis, each dividing the largest:
  4:2:0, 4:1:1, 3x, 4x, ...); restart intervals; to the bytes of Pillow's
  libjpeg-turbo decode: the integer inverse DCT of ``jidctint.c``, the
  upsampling ``jdsample.c`` picks for each ratio (fancy at 2x, else
  repeated samples) and the fixed-point YCbCr -> RGB of ``jdcolor.c``, all
  bit for bit; arithmetic-coded sequential and progressive files (SOF9,
  SOF10: `jpeg_arith`) and lossless ones (SOF3: `jpeg_lossless`) too.
  Hierarchical files, 12-bit samples and arithmetic lossless files (SOF11)
  raise, as in Pillow.
* `encode_jpeg`: the file Pillow writes for ``Image.save(..., "JPEG",
  quality=q)``: JFIF, baseline, 4:2:0, the Annex K tables scaled as
  ``jcparam.c`` scales them, the standard Huffman tables, and
  ``jccolor.c``, ``jcsample.c``, ``jfdctint.c`` and ``jcdctmgr.c``'s integer
  stages, so the quantized coefficients are Pillow's.
* `encode_png`: 8-bit RGB, filter 0 on every row (also for ``.apng``, as
  Pillow writes one frame without ``save_all``).
* `decode_image` tells the format by the first bytes in Pillow's order and
  `write_image` by the extension, with Pillow's extension table; any other
  file or extension raises ``ValueError``, naming it.

The Huffman decode and encode (and the arithmetic and lossless scans) run
in `native` (host C++) where g++ built it, else in the Python loops here
(`_decode_scan_py`, `_encode_scan_py`) and in `jpeg_arith` and
`jpeg_lossless`, which give the same output and which the tests hold the
native ones to.
The stages around them are NumPy over all blocks at once.
"""

from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

from path_tracer_tpu_torch import native
from path_tracer_tpu_torch.utils import bmp, gif, jpeg_arith, jpeg_lossless, netpbm, tga, tiff, webp

# --------------------------------------------------------------------- PNG

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))  # (x0, y0, dx, dy) of each pass


def _unfilter(filtered: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters: ``filtered [H, W, bpp]`` uint8 bytes,
    ``types [H]`` each row's filter type. Each byte's predictor reads its
    left, up and up-left neighbours of the reconstructed image, so the
    sweep goes over anti-diagonals (every pixel of one depends only on
    earlier ones), vectorized along each; integer arithmetic throughout."""
    h, w, _ = filtered.shape
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row above, a zero column left
    f = filtered.astype(np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = rec[ys + 1, xs]  # left
        b = rec[ys, xs + 1]  # up
        c = rec[ys, xs]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = types[ys][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, paeth], 0)
        rec[ys + 1, xs + 1] = (f[ys, xs] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def _png_samples(raw: np.ndarray, pos: int, w: int, h: int, depth: int, ch: int, name: str):
    """The ``h`` filtered scanlines of a ``w``-wide (sub)image at
    ``raw[pos:]`` -> (samples ``[h, w, ch]`` uint8, the position after
    them). 16-bit samples keep their high byte; 1/2/4-bit ones stay
    0..2^d-1."""
    rowbytes = (w * depth * ch + 7) // 8
    n = h * (rowbytes + 1)
    if raw.size < pos + n:
        raise ValueError(f"{name}: PNG image data is truncated")
    rows = raw[pos:pos + n].reshape(h, rowbytes + 1)
    types = rows[:, 0].astype(np.int32)
    if (types > 4).any():
        raise ValueError(f"{name}: unknown PNG filter type {int(types.max())}")
    bpp = max(1, depth * ch // 8)  # the filters' byte distance to the left pixel
    px = _unfilter(rows[:, 1:].reshape(h, rowbytes // bpp, bpp), types, bpp).reshape(h, rowbytes)
    if depth == 16:
        return px.reshape(h, w, ch, 2)[..., 0], pos + n
    if depth == 8:
        return px.reshape(h, w, ch), pos + n
    bits = np.unpackbits(px, axis=1).reshape(h, rowbytes * 8 // depth, depth)
    vals = bits @ (1 << np.arange(depth - 1, -1, -1))
    return vals[:, :w, None].astype(np.uint8), pos + n


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG file's bytes -> uint8 RGB ``[H, W, 3]``, Pillow's
    ``Image.open(...).convert("RGB")`` but for 16-bit gray, whose high byte
    is kept (Pillow clips it to 255). Raises ``ValueError`` naming ``name``
    for anything else."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR" and len(body) == 13:
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[: len(body) // 3 * 3].reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} is not a PNG colour type")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{name}: {depth}-bit samples are not allowed in PNG colour type {ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"{name}: unknown PNG interlace method {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: bad PNG image data ({e})") from None
    if not interlace:
        px, _ = _png_samples(raw, 0, w, h, depth, ch, name)
    else:  # Adam7: seven subimages, each with its own scanlines and filters
        passes = [(x0, y0, dx, dy, -(-(w - x0) // dx), -(-(h - y0) // dy)) for x0, y0, dx, dy in _ADAM7]
        passes = [p for p in passes if p[4] > 0 and p[5] > 0]
        if raw.size < sum(ph * ((pw * depth * ch + 7) // 8 + 1) for *_, pw, ph in passes):
            raise ValueError(f"{name}: PNG image data is truncated")
        px, pos = np.zeros((h, w, ch), np.uint8), 0
        for x0, y0, dx, dy, pw, ph in passes:
            px[y0::dy, x0::dx], pos = _png_samples(raw, pos, pw, ph, depth, ch, name)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)  # indices past the PLTE chunk are black, as in Pillow
        lut[: palette.shape[0]] = palette[:256]
        return lut[px[..., 0]]
    if ctype in (0, 4):
        gray = px[..., :1] * np.uint8(255 // ((1 << min(depth, 8)) - 1))
        return np.repeat(gray, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def encode_png(rgb8: np.ndarray) -> bytes:
    """8-bit RGB ``[H, W, 3]`` -> PNG file bytes (filter 0 on every row)."""
    h, w, _ = rgb8.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    return (
        _PNG_SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


# -------------------------------------------------------------------- JPEG

def _zigzag() -> np.ndarray:
    """Natural (row-major) index of each zigzag position."""
    cells = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1], rc[0] if (rc[0] + rc[1]) % 2 else rc[1]))
    return np.array([r * 8 + c for r, c in cells], np.int64)


_ZIGZAG = _zigzag()
# jdhuff.c's jpeg_natural_order with its 16 guard entries: a corrupt run
# length past position 63 writes position 63, as libjpeg does
_NATURAL = np.concatenate([_ZIGZAG, np.full(16, 63, np.int64)])

# Annex K quantization tables, natural order (jcparam.c)
_STD_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
             + [99] * 32, np.int64),
)
# Annex K Huffman tables (jstdhuff.c): (code counts by length 1..16, symbols)
_STD_HUFF = {
    "dc0": ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    "dc1": ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    "ac0": ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25"
        "262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a83"
        "8485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3"
        "d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    "ac1": ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718"
        "191a262728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a"
        "82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9ca"
        "d2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}
_JFIF_APP0 = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
_END_OF_SCAN = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")  # the marker after a scan's data
_RESTART = re.compile(rb"\xff+[\xd0-\xd7]")
_SCAN_PAD = 1024  # zero bytes after a scan's data: one block reads at most ~270 bytes


def _huffman_codes(counts, symbols, name: str):
    """Canonical codes (Annex C) of a DHT table: ``(symbol, code, length)``
    of each symbol in order. Raises for a table whose codes overflow."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length) - 1:  # jdhuff.c: no code is all ones
                raise ValueError(f"{name}: bad JPEG Huffman table")
            out.append((symbols[k], code, length))
            code += 1
            k += 1
        code <<= 1
    return out


def _decode_lut(counts, symbols, name: str) -> np.ndarray:
    """A Huffman table as a 16-bit lookahead table: entry ``length << 8 |
    symbol`` for every 16-bit window that starts with a code, 0 else."""
    lut = np.zeros(1 << 16, np.uint16)
    for sym, code, length in _huffman_codes(counts, symbols, name):
        lut[code << (16 - length):(code + 1) << (16 - length)] = (length << 8) | sym
    return lut


def _encode_table(counts, symbols) -> tuple[np.ndarray, np.ndarray]:
    """A Huffman table as ``(code [256] uint32, length [256] uint8)`` by
    symbol (jchuff.c's ehufco / ehufsi)."""
    code = np.zeros(256, np.uint32)
    size = np.zeros(256, np.uint8)
    for sym, c, length in _huffman_codes(counts, symbols, "<Annex K>"):
        code[sym], size[sym] = c, length
    return code, size


# --- the entropy coders, Python versions (native.jpeg_* are their twins) ---


def _decode_scan_py(data: bytes, starts, coefs, geom, luts, mcus_x, mcus_y,
                    ss, se, ah, al, restart) -> int:
    """Huffman-decode one scan into the coefficient arrays, in place.

    ``data`` is the scan's entropy-coded bytes with the stuffing removed,
    each restart interval ``data[starts[i]:starts[i+1]]`` (and ``_SCAN_PAD``
    zero bytes after the last); ``coefs[c]`` the int16 ``[rows, cols, 64]``
    blocks (natural order) of the scan's c-th component, ``geom[c] = (h,
    v)`` its blocks per MCU, ``luts[c] = (dc, ac)`` its tables as
    `_decode_lut`s. Sequential scans have ``ss, se, ah, al = 0, 63, 0, 0``;
    otherwise a progressive scan (DC first / refine, AC first / refine,
    jdphuff.c). Returns 0, -1 for a bad Huffman code, -2 for a block that
    reads past its interval's data, -3 when the restart intervals do not
    match."""
    b = np.frombuffer(data, np.uint8).astype(np.uint32)
    w32 = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
    lists = [c.reshape(-1).tolist() for c in coefs]
    tabs = [(dc.tolist(), ac.tolist()) for dc, ac in luts]
    nat = _NATURAL.tolist()
    n_mcu = mcus_x * mcus_y
    interval = restart or n_mcu
    if len(starts) - 1 != -(-n_mcu // interval):
        return -3
    blocks = []  # (component, offset in its list from the MCU's origin)
    for ci, (h, v) in enumerate(geom):
        cols = coefs[ci].shape[1]
        blocks += [(ci, (y * cols + x) * 64) for y in range(v) for x in range(h)]
    strides = [(v * coefs[ci].shape[1] * 64, h * 64) for ci, (h, v) in enumerate(geom)]
    sequential = (ss, se, ah, al) == (0, 63, 0, 0)  # else a progressive scan
    p1, m1 = 1 << al, -1 << al

    for it in range(len(starts) - 1):
        pos, end = starts[it] * 8, starts[it + 1] * 8
        pred = [0] * len(coefs)
        eobrun = 0
        for m in range(it * interval, min(n_mcu, (it + 1) * interval)):
            my, mx = divmod(m, mcus_x)
            for ci, off in blocks:
                co = lists[ci]
                base = my * strides[ci][0] + mx * strides[ci][1] + off
                dct, act = tabs[ci]
                if ss == 0 and ah == 0:  # DC (sequential, or the first stage)
                    e = dct[(w32[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                    if not e:
                        return -1
                    pos += e >> 8
                    s = e & 255
                    if s:
                        if s > 16:
                            return -1
                        r = ((w32[pos >> 3] << (pos & 7)) & 0xFFFFFFFF) >> (32 - s)
                        pos += s
                        if r < (1 << (s - 1)):
                            r -= (1 << s) - 1
                        pred[ci] += r
                    co[base] = pred[ci] << al
                elif ss == 0:  # DC refinement: one bit
                    if (w32[pos >> 3] << (pos & 7)) & 0x80000000:
                        co[base] |= p1
                    pos += 1
                if sequential:
                    k = 1
                    while k < 64:
                        e = act[(w32[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                        if not e:
                            return -1
                        pos += e >> 8
                        r, s = (e & 255) >> 4, e & 15
                        if s:
                            k += r
                            x = ((w32[pos >> 3] << (pos & 7)) & 0xFFFFFFFF) >> (32 - s)
                            pos += s
                            if x < (1 << (s - 1)):
                                x -= (1 << s) - 1
                            co[base + nat[k]] = x
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
                elif ss and not ah:  # AC first stage
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = ss
                    while k <= se:
                        e = act[(w32[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                        if not e:
                            return -1
                        pos += e >> 8
                        r, s = (e & 255) >> 4, e & 15
                        if s:
                            k += r
                            x = ((w32[pos >> 3] << (pos & 7)) & 0xFFFFFFFF) >> (32 - s)
                            pos += s
                            if x < (1 << (s - 1)):
                                x -= (1 << s) - 1
                            co[base + nat[k]] = x << al
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = 1 << r
                            if r:
                                eobrun += ((w32[pos >> 3] << (pos & 7)) & 0xFFFFFFFF) >> (32 - r)
                                pos += r
                            eobrun -= 1
                            break
                        k += 1
                elif ss:  # AC refinement
                    k = ss
                    if not eobrun:
                        while k <= se:
                            e = act[(w32[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                            if not e:
                                return -1
                            pos += e >> 8
                            r, s = (e & 255) >> 4, e & 15
                            if s:  # a newly nonzero coefficient: its sign bit
                                s = p1 if (w32[pos >> 3] << (pos & 7)) & 0x80000000 else m1
                                pos += 1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += ((w32[pos >> 3] << (pos & 7)) & 0xFFFFFFFF) >> (32 - r)
                                    pos += r
                                break
                            while k <= se:  # correction bits of nonzeros, r zeros skipped
                                j = base + nat[k]
                                if co[j]:
                                    if (w32[pos >> 3] << (pos & 7)) & 0x80000000 and not co[j] & p1:
                                        co[j] += p1 if co[j] >= 0 else m1
                                    pos += 1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if s:
                                co[base + nat[k]] = s
                            k += 1
                    if eobrun:
                        while k <= se:
                            j = base + nat[k]
                            if co[j]:
                                if (w32[pos >> 3] << (pos & 7)) & 0x80000000 and not co[j] & p1:
                                    co[j] += p1 if co[j] >= 0 else m1
                                pos += 1
                            k += 1
                        eobrun -= 1
                if pos > end:
                    return -2
    for c, lst in zip(coefs, lists):
        c[...] = np.asarray(lst, np.int64).astype(np.int16).reshape(c.shape)  # int16 wrap, as JCOEF
    return 0


def _encode_scan_py(blocks: np.ndarray, sel: np.ndarray, codes, sizes) -> bytes:
    """Huffman-encode quantized blocks (jchuff.c encode_one_block): ``blocks
    [n, 64]`` int16 in natural order and in scan order, ``sel[n]`` each
    block's component (its DC predictor and its tables ``codes[2 * c]``
    (DC) and ``codes[2 * c + 1]`` (AC), and the same of ``sizes``). The
    entropy-coded bytes, 0xFF stuffed, the last byte padded with 1-bits."""
    zz = blocks[:, _ZIGZAG].tolist()
    sel = sel.tolist()
    codes = [c.tolist() for c in codes]
    sizes = [s.tolist() for s in sizes]
    out = bytearray()
    acc, nacc = 0, 0
    pred = [0] * (max(sel) + 1 if sel else 0)

    def emit(code, size):
        nonlocal acc, nacc
        acc = (acc << size) | code
        nacc += size
        while nacc >= 8:
            nacc -= 8
            byte = (acc >> nacc) & 255
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << nacc) - 1

    for blk, c in zip(zz, sel):
        dcc, dcs, acc_t, acs = codes[2 * c], sizes[2 * c], codes[2 * c + 1], sizes[2 * c + 1]
        t = blk[0] - pred[c]
        pred[c] = blk[0]
        nbits = abs(t).bit_length()
        emit(dcc[nbits], dcs[nbits])
        if nbits:
            emit((t if t >= 0 else t - 1) & ((1 << nbits) - 1), nbits)
        r = 0
        for k in range(1, 64):
            t = blk[k]
            if not t:
                r += 1
                continue
            while r > 15:
                emit(acc_t[0xF0], acs[0xF0])
                r -= 16
            nbits = abs(t).bit_length()
            emit(acc_t[(r << 4) + nbits], acs[(r << 4) + nbits])
            emit((t if t >= 0 else t - 1) & ((1 << nbits) - 1), nbits)
            r = 0
        if r:
            emit(acc_t[0], acs[0])
    if nacc:
        emit((1 << (8 - nacc)) - 1, 8 - nacc)
    return bytes(out)


# --- the integer stages of libjpeg(-turbo) ---

_FIX = {  # jidctint.c / jfdctint.c: FIX(x) at CONST_BITS = 13
    "0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
    "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
    "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172,
}
_CHUNK = 1 << 15  # blocks per NumPy batch of the DCT stages (bounds their memory)


def _idct_sums(x):
    """One pass of jidctint.c's jpeg_idct_islow on the 8 inputs ``x[0..7]``:
    its 8 sums before the DESCALE (11 bits in pass 1, 18 in pass 2)."""
    f = _FIX
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * f["0_541196100"]
    tmp2 = z1 - z3 * f["1_847759065"]
    tmp3 = z1 + z2 * f["0_765366865"]
    tmp0 = (x[0] + x[4]) * (1 << 13)
    tmp1 = (x[0] - x[4]) * (1 << 13)
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0 = t0 * f["0_298631336"]
    t1 = t1 * f["2_053119869"]
    t2 = t2 * f["3_072711026"]
    t3 = t3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _fdct_sums(x):
    """One pass of jfdctint.c's jpeg_fdct_islow on ``x[0..7]``: its 8 sums
    before the DESCALE (11 bits in pass 1, 15 in pass 2). Outputs 0 and 4
    are ``<< 2`` in pass 1 and ``DESCALE(., 2)`` in pass 2; scaled by
    ``1 << 13`` they take the other outputs' descale, exactly."""
    f = _FIX
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    out[0] = (tmp10 + tmp11) * (1 << 13)
    out[4] = (tmp10 - tmp11) * (1 << 13)
    z1 = (tmp12 + tmp13) * f["0_541196100"]
    out[2] = z1 + tmp13 * f["0_765366865"]
    out[6] = z1 - tmp12 * f["1_847759065"]
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * f["1_175875602"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    out[7] = tmp4 * f["0_298631336"] + z1 + z3
    out[5] = tmp5 * f["2_053119869"] + z2 + z4
    out[3] = tmp6 * f["3_072711026"] + z2 + z3
    out[1] = tmp7 * f["1_501321110"] + z1 + z4
    return out


def _descale(v: np.ndarray, n: int) -> np.ndarray:
    """jdct.h DESCALE: round half up, arithmetic shift."""
    return (v + (1 << (n - 1))) >> n


def _range_limit() -> np.ndarray:
    """jdmaster.c's post-IDCT table, indexed by ``x & 1023``: -128..127 ->
    0..255, then 255 up to 511 and 0 from -512."""
    v = np.arange(1024)
    return np.where(v < 128, v + 128, np.where(v < 512, 255, np.where(v < 896, 0, v - 896))).astype(np.uint8)


_RANGE_LIMIT = _range_limit()


def _idct_islow_np(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Dequantize and inverse-DCT ``coef [N, 64]`` int16 (natural order)
    with the quantization table ``q [64]`` -> samples ``[N, 64]`` uint8
    (row-major), as jidctint.c: columns, the workspace in C ``int``, then
    rows through the post-IDCT range limit."""
    out = np.empty((coef.shape[0], 64), np.uint8)
    qs = q.astype(np.int16).astype(np.int64)  # ISLOW_MULT_TYPE is 16-bit
    for s in range(0, coef.shape[0], _CHUNK):
        x = (coef[s:s + _CHUNK].astype(np.int64) * qs).reshape(-1, 8, 8)
        ws = np.stack([_descale(v, 11) for v in _idct_sums([x[:, u, :] for u in range(8)])], axis=1)
        ws = ws.astype(np.int32).astype(np.int64)
        v = np.stack(_idct_sums([ws[:, :, u] for u in range(8)]), axis=2)
        out[s:s + _CHUNK] = _RANGE_LIMIT[_descale(v, 18) & 1023].reshape(-1, 64)
    return out


def _idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    if native.available():
        return native.jpeg_idct_islow(coef, q)
    return _idct_islow_np(coef, q)


def _divisors(q: np.ndarray):
    """jcdctmgr.c compute_reciprocal for the islow DCT (divisor ``q << 3``)
    with 16-bit DCTELEMs: ``(reciprocal, correction, shift)`` [64] each."""
    recip, corr, shift = (np.zeros(64, np.int64) for _ in range(3))
    for i, d in enumerate((q.astype(np.int64) << 3).tolist()):
        r = 16 + d.bit_length() - 1
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    return recip, corr, shift


def _fdct_quantize_np(samples: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Forward DCT and quantize ``samples [N, 64]`` uint8 (row-major) ->
    ``[N, 64]`` int16 (natural order): jcdctmgr.c's level shift,
    jpeg_fdct_islow (rows, then columns) and its reciprocal quantizer."""
    recip, corr, shift = _divisors(q)
    out = np.empty((samples.shape[0], 64), np.int16)
    for s in range(0, samples.shape[0], _CHUNK):
        x = samples[s:s + _CHUNK].astype(np.int64).reshape(-1, 8, 8) - 128
        ws = np.stack([_descale(v, 11) for v in _fdct_sums([x[:, :, u] for u in range(8)])], axis=2)
        d = np.stack([_descale(v, 15) for v in _fdct_sums([ws[:, u, :] for u in range(8)])], axis=1)
        d = d.reshape(-1, 64)
        qv = ((np.abs(d) + corr) * recip) >> shift
        out[s:s + _CHUNK] = np.where(d < 0, -qv, qv)
    return out


def _fdct_quantize(samples: np.ndarray, q: np.ndarray) -> np.ndarray:
    if native.available():
        return native.jpeg_fdct_quantize(samples, *_divisors(q))
    return _fdct_quantize_np(samples, q)


def _blocks(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """``plane [rows*8, cols*8]`` -> blocks ``[rows*cols, 64]`` (row-major)."""
    return plane.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3).reshape(-1, 64)


def _unblocks(blocks: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return blocks.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)


def _edge(a: np.ndarray, axis: int, before: bool) -> np.ndarray:
    """``a`` shifted by one along ``axis``, its edge sample replicated: the
    previous sample (``before``) or the next one."""
    n = a.shape[axis]
    idx = np.clip(np.arange(n) + (-1 if before else 1), 0, n - 1)
    return np.take(a, idx, axis=axis)


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    """Samples of ``a`` and ``b`` alternating along ``axis``."""
    return np.stack([a, b], axis=axis + 1).reshape(
        a.shape[:axis] + (2 * a.shape[axis],) + a.shape[axis + 1:])


def _upsample(c: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """jdsample.c with do_fancy_upsampling (libjpeg-turbo's default): a
    component's ``[h, w]`` samples to ``fy`` x ``fx`` times as many, by the
    ratio to the largest factors. 2x horizontally (with or without 2x
    vertically) is fancy only above 2 samples wide; narrower, and for any
    other ratio (3x, 4x, 4x by 2x, ...), samples repeat (int_upsample)."""
    c = c.astype(np.int32)
    if fx == 2 and fy == 2 and c.shape[1] > 2:  # h2v2_fancy_upsample
        up = 3 * c + _edge(c, 0, True)
        down = 3 * c + _edge(c, 0, False)
        cs = _interleave(up, down, 0)  # column sums, the nearer row weighted 3
        left = (3 * cs + _edge(cs, 1, True) + 8) >> 4
        right = (3 * cs + _edge(cs, 1, False) + 7) >> 4
        return _interleave(left, right, 1).astype(np.uint8)
    if fx == 2 and fy == 1 and c.shape[1] > 2:  # h2v1_fancy_upsample
        left = (3 * c + _edge(c, 1, True) + 1) >> 2
        right = (3 * c + _edge(c, 1, False) + 2) >> 2
        return _interleave(left, right, 1).astype(np.uint8)
    if fx == 1 and fy == 2:  # h1v2_fancy_upsample
        up = (3 * c + _edge(c, 0, True) + 1) >> 2
        down = (3 * c + _edge(c, 0, False) + 2) >> 2
        return _interleave(up, down, 0).astype(np.uint8)
    return np.repeat(np.repeat(c, fy, axis=0), fx, axis=1).astype(np.uint8)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert (16-bit fixed point, its rounding)."""
    one_half = 1 << 15
    y = y.astype(np.int32)
    cb = cb.astype(np.int32) - 128
    cr = cr.astype(np.int32) - 128
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = np.clip(y + ((91881 * cr + one_half) >> 16), 0, 255)  # FIX(1.40200)
    out[..., 1] = np.clip(y + ((-22554 * cb + one_half - 46802 * cr) >> 16), 0, 255)  # FIX(0.34414), FIX(0.71414)
    out[..., 2] = np.clip(y + ((116130 * cb + one_half) >> 16), 0, 255)  # FIX(1.77200)
    return out


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c rgb_ycc_convert: (Y, Cb, Cr) planes, uint8."""
    one_half = 1 << 15
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    y = (19595 * r + 38470 * g + 7471 * b + one_half) >> 16
    offset = (128 << 16) + one_half - 1  # CBCR_OFFSET + ONE_HALF - 1
    cb = (-11059 * r - 21709 * g + 32768 * b + offset) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + offset) >> 16
    return tuple(p.astype(np.uint8) for p in (y, cb, cr))


def _pad_edge(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Replicate the last row and column out to ``[rows, cols]``."""
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


# --- decode ---

# SOF markers: (entropy coding, process); hierarchical ones raise, as in
# libjpeg-turbo (and so in Pillow)
_SOF = {0xC0: ("huffman", "sequential"), 0xC1: ("huffman", "sequential"), 0xC2: ("huffman", "progressive"),
        0xC3: ("huffman", "lossless"), 0xC9: ("arithmetic", "sequential"),
        0xCA: ("arithmetic", "progressive"), 0xCB: ("arithmetic", "lossless")}
_UNSUPPORTED_SOF = {0xC5: "hierarchical", 0xC6: "hierarchical", 0xC7: "hierarchical",
                    0xCD: "hierarchical", 0xCE: "hierarchical", 0xCF: "hierarchical"}


def _decode_scan(*args) -> int:
    if native.available():
        return native.jpeg_decode_scan(*args)
    return _decode_scan_py(*args)


def _arith_scan(*args) -> int:
    if native.available():
        return native.jpeg_arith_decode_scan(*args, jpeg_arith.QE)
    return jpeg_arith.decode_scan_py(*args)


def _lossless_scan(*args) -> int:
    if native.available():
        return native.jpeg_lossless_decode_scan(*args)
    return jpeg_lossless.decode_scan_py(*args)


def decode_jpeg(data: bytes, name: str = "<bytes>", colour: str | None = None) -> np.ndarray:
    """A JPEG file's bytes -> uint8 RGB ``[H, W, 3]``, equal to Pillow's
    ``Image.open(...).convert("RGB")`` (libjpeg-turbo's defaults). Raises
    ``ValueError`` naming ``name`` and what it lacks.

    ``colour`` overrides the colour space the file's markers imply, as
    libtiff does for a TIFF's JPEG strips: ``"raw"`` keeps the components
    as they are (gray, RGB, or CMYK read without inversion), ``"ycc"``
    converts YCbCr to RGB."""
    frame, comps, jfif, adobe = _read_jpeg(data, name)
    hgt, wid, hmax, vmax = frame["hgt"], frame["wid"], frame["hmax"], frame["vmax"]
    lossless = frame["process"] == "lossless"
    planes = []
    for c in comps:
        if lossless:  # jdsample.c: no fancy upsampling when the DCT size is 1
            s = c["samples"]
            planes.append(np.repeat(np.repeat(s, vmax // c["v"], axis=0), hmax // c["h"], axis=1)[:hgt, :wid])
            continue
        bh, bw = -(-c["hgt"] // 8), -(-c["w"] // 8)
        q = c["q"] if c["q"] is not None else np.zeros(64, np.int64)
        s = _unblocks(_idct_islow(c["coef"][:bh, :bw].reshape(-1, 64), q), bh, bw)
        s = _upsample(s[:c["hgt"], :c["w"]], hmax // c["h"], vmax // c["v"])
        planes.append(s[:hgt, :wid])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    ids = tuple(c["id"] for c in comps)
    if colour == "raw":
        if len(planes) == 4:
            return _cmyk_to_rgb(np.stack(planes[:3], axis=-1).astype(np.int32), planes[3].astype(np.int32))
        return np.stack(planes, axis=-1)
    if colour == "ycc":
        return _ycc_to_rgb(*planes[:3])
    # jdapimin.c default_decompress_parms: the file's colour space
    ycc = jfif or (adobe != 0 if adobe is not None else not lossless and ids != (82, 71, 66))
    if lossless and ycc and (len(planes) == 3 or adobe):
        raise ValueError(f"{name}: lossless JPEG in YCbCr or YCCK (a JFIF or Adobe marker); libjpeg-turbo, "
                         "and so Pillow, converts no colours in lossless mode")
    if len(planes) == 4:  # Pillow decodes to CMYK and reads it as "CMYK;I"
        if adobe is not None and adobe != 0:  # YCCK -> CMYK (jdcolor.c ycck_cmyk_convert)
            cmy = 255 - _ycc_to_rgb(*planes[:3]).astype(np.int32)
        else:
            cmy = np.stack(planes[:3], axis=-1).astype(np.int32)
        return _cmyk_to_rgb(255 - cmy, 255 - planes[3].astype(np.int32))
    return _ycc_to_rgb(*planes) if ycc else np.stack(planes, axis=-1)


def _read_jpeg(data: bytes, name: str):
    """Parse a JPEG file and decode its scans: ``(frame, components, JFIF
    seen, Adobe transform or None)``, each component with its coefficient
    blocks (``coef``) and quantization table (``q``), or in a lossless
    file its samples (``samples``)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    pos, qt, huff, restart = 2, {}, {}, 0
    frame, comps, jfif, adobe, scans = None, [], False, None, 0
    cond = (np.zeros(16, np.int64), np.ones(16, np.int64), np.full(16, 5, np.int64))  # DAC: L, U, Kx
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: JPEG marker expected at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= len(data):
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:  # EOI
            break
        if 0xD0 <= m <= 0xD7 or m in (0x01, 0xD8):
            continue
        if pos + 2 > len(data):
            raise ValueError(f"{name}: JPEG data is truncated")
        (n,) = struct.unpack(">H", data[pos:pos + 2])
        seg, pos = data[pos + 2:pos + n], pos + n
        if len(seg) < n - 2:
            raise ValueError(f"{name}: JPEG data is truncated")
        if m == 0xDB:  # DQT: 8- or 16-bit tables, zigzag order
            i = 0
            while i < len(seg):
                prec, tid = seg[i] >> 4, seg[i] & 15
                if prec > 1 or len(seg) < i + 1 + 64 * (prec + 1):
                    raise ValueError(f"{name}: bad JPEG quantization table")
                vals = np.frombuffer(seg[i + 1:i + 1 + 64 * (prec + 1)], ">u2" if prec else np.uint8)
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = vals
                qt[tid] = q
                i += 1 + 64 * (prec + 1)
        elif m == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                counts = tuple(seg[i + 1:i + 17])
                k = sum(counts)
                if len(counts) < 16 or len(seg) < i + 17 + k:
                    raise ValueError(f"{name}: bad JPEG Huffman table")
                huff[(seg[i] >> 4, seg[i] & 15)] = _decode_lut(counts, seg[i + 17:i + 17 + k], name)
                i += 17 + k
        elif m == 0xCC:  # DAC (jdmarker.c get_dac)
            if len(seg) % 2:
                raise ValueError(f"{name}: bad JPEG arithmetic conditioning (DAC) segment")
            for i in range(0, len(seg), 2):
                index, val = seg[i], seg[i + 1]
                if index >= 32 or (index < 16 and (val & 15) > (val >> 4)):
                    raise ValueError(f"{name}: bad JPEG arithmetic conditioning table {index}")
                if index >= 16:
                    cond[2][index - 16] = val
                else:
                    cond[0][index], cond[1][index] = val & 15, val >> 4
        elif m in _SOF:
            if frame is not None or len(seg) < 6 or len(seg) < 6 + 3 * seg[5]:
                raise ValueError(f"{name}: bad or second JPEG frame header")
            prec, hgt, wid, nf = struct.unpack(">BHHB", seg[:6])
            coding, process = _SOF[m]
            if prec != 8:
                raise ValueError(f"{name}: {prec}-bit JPEG; only 8-bit samples are supported")
            if coding == "arithmetic" and process == "lossless":
                # libjpeg-turbo has no arithmetic lossless decoder (JERR_ARITH_NOTIMPL)
                raise ValueError(f"{name}: arithmetic-coded lossless JPEG (SOF11); libjpeg-turbo, "
                                 "and so Pillow, does not decode it either")
            if nf not in (1, 3, 4):
                raise ValueError(f"{name}: {nf}-component JPEG; only 1, 3 and 4-component "
                                 "(gray, YCbCr or RGB, CMYK or YCCK) JPEG is supported")
            if hgt == 0 or wid == 0:
                raise ValueError(f"{name}: JPEG without a frame height (DNL) or width")
            if wid * hgt > 2 * 89478485:  # Image.MAX_IMAGE_PIXELS: Pillow's decompression bomb error
                raise ValueError(f"{name}: JPEG of {wid}x{hgt} pixels; Pillow refuses images over "
                                 "178,956,970 pixels")
            raw = [tuple(seg[6 + 3 * i:9 + 3 * i]) for i in range(nf)]
            factors = [(c[1] >> 4, c[1] & 15) for c in raw]
            hmax = max(f[0] for f in factors) if nf > 1 else factors[0][0]
            vmax = max(f[1] for f in factors) if nf > 1 else factors[0][1]
            # jdinput.c: factors 1..4; jdsample.c: integral ratios only
            if any(not (1 <= h <= 4 and 1 <= v <= 4) or (nf > 1 and (hmax % h or vmax % v))
                   for h, v in factors):
                raise ValueError(f"{name}: JPEG sampling factors {factors} are not supported "
                                 "(libjpeg: 1 to 4, each dividing the largest)")
            unit = 1 if process == "lossless" else 8  # a data unit: a sample or a block
            mx, my = -(-wid // (unit * hmax)), -(-hgt // (unit * vmax))
            for cid, hv, tq in raw:
                h, v = (hv >> 4, hv & 15) if nf > 1 else (hmax, vmax)
                cw, chh = -(-wid * h // hmax), -(-hgt * v // vmax)
                c = {"id": cid, "h": h, "v": v, "tq": tq, "w": cw, "hgt": chh, "q": None}
                if process == "lossless":
                    c["samples"] = np.zeros((chh, cw), np.uint8)
                else:
                    c["coef"] = np.zeros((my * v, mx * h, 64), np.int16)
                comps.append(c)
            frame = {"hgt": hgt, "wid": wid, "hmax": hmax, "vmax": vmax, "coding": coding, "process": process}
        elif m in _UNSUPPORTED_SOF:
            raise ValueError(f"{name}: {_UNSUPPORTED_SOF[m]} JPEG (marker 0x{m:02X}); libjpeg-turbo, and "
                             "so Pillow, does not decode it either")
        elif m == 0xDD and len(seg) >= 2:
            (restart,) = struct.unpack(">H", seg[:2])
        elif m == 0xE0 and seg[:5] == b"JFIF\x00" and n >= 16:
            jfif = True
        elif m == 0xEE and seg[:5] == b"Adobe" and n >= 14:
            adobe = seg[11]
        elif m == 0xDA:
            if frame is None or not seg or not 1 <= seg[0] <= 4 or len(seg) < 4 + 2 * seg[0]:
                raise ValueError(f"{name}: bad JPEG scan header, or a scan before the frame")
            end = _END_OF_SCAN.search(data, pos)
            end = end.start() if end else len(data)
            if frame["process"] == "lossless":
                _scan_lossless(seg, data[pos:end], frame, comps, huff, restart, name)
            else:
                _scan(seg, data[pos:end], frame, comps, qt, huff, cond, restart, name)
            pos, scans = end, scans + 1
    if frame is None or not scans:
        raise ValueError(f"{name}: JPEG without a frame or a scan")
    return frame, comps, jfif, adobe


def _cmyk_to_rgb(cmy: np.ndarray, k: np.ndarray) -> np.ndarray:
    """libImaging's cmyk2rgb: ``nk - nk * c / 255`` with ``nk = 255 - k``,
    through its rounded MULDIV255."""
    nk = (255 - k)[..., None]
    t = cmy * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _scan_components(header: bytes, comps, name):
    """A SOS header's components: ``[(component, Td, Ta)]`` and the bytes
    after the component list (Ss, Se, Ah/Al)."""
    ns = header[0]
    by_id = {c["id"]: c for c in comps}
    sel = []
    for i in range(ns):
        cid, tt = header[1 + 2 * i], header[2 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"{name}: JPEG scan names an unknown component {cid}")
        sel.append((by_id[cid], tt >> 4, tt & 15))
    return sel, header[1 + 2 * ns:4 + 2 * ns]


def _segments(ent: bytes):
    """A scan's entropy-coded bytes split at its restart markers, the
    stuffing removed: (the bytes, each interval's start and the end)."""
    segs = [p.replace(b"\xff\x00", b"\xff") for p in _RESTART.split(ent)]
    return b"".join(segs), np.cumsum([0] + [len(p) for p in segs]).tolist()


_SCAN_ERRORS = {-1: "bad Huffman code in the JPEG data", -2: "JPEG image data is truncated",
                -3: "JPEG restart markers do not match the restart interval"}


def _scan(header: bytes, ent: bytes, frame, comps, qt, huff, cond, restart, name):
    """Parse a SOS header and decode its entropy-coded data ``ent`` into
    the components' coefficients (Huffman or arithmetic coding)."""
    hgt, wid, hmax, vmax = frame["hgt"], frame["wid"], frame["hmax"], frame["vmax"]
    arith = frame["coding"] == "arithmetic"
    sel, (ss, se, a) = _scan_components(header, comps, name)
    ns = len(sel)
    ah, al = a >> 4, a & 15
    if frame["process"] != "progressive":
        ss, se, ah, al = 0, 63, 0, 0
    elif ss > se or se > 63 or (ss == 0 and se != 0) or (ss and ns != 1) or al > 13:
        raise ValueError(f"{name}: bad progressive JPEG scan (Ss {ss}, Se {se}, Ah {ah}, Al {al})")
    luts, coefs, geom = [], [], []
    for c, td, ta in sel:
        if c["q"] is None:  # libjpeg latches each table at its component's first scan
            if c["tq"] not in qt:
                raise ValueError(f"{name}: JPEG quantization table {c['tq']} is missing")
            c["q"] = qt[c["tq"]].copy()
        if arith:
            luts.append((td, ta))
        else:
            need = ([(0, td)] if ss == 0 and ah == 0 else []) + ([(1, ta)] if se > 0 else [])
            for key in need:
                if key not in huff:
                    raise ValueError(f"{name}: JPEG Huffman table {key} is missing")
            empty = np.zeros(1 << 16, np.uint16)
            luts.append((huff.get((0, td), empty), huff.get((1, ta), empty)))
        if ns == 1:  # non-interleaved: one block an MCU, the component's own block grid
            bh, bw = -(-c["hgt"] // 8), -(-c["w"] // 8)
            coefs.append(c["coef"][:bh, :bw])
            geom.append((1, 1))
        else:
            coefs.append(c["coef"])
            geom.append((c["h"], c["v"]))
    if ns == 1:
        mcus_y, mcus_x = coefs[0].shape[:2]
    elif sum(h * v for h, v in geom) > 10:  # jdinput.c D_MAX_BLOCKS_IN_MCU
        raise ValueError(f"{name}: JPEG scan of {sum(h * v for h, v in geom)} blocks an MCU "
                         "(libjpeg takes at most 10)")
    else:
        mcus_x, mcus_y = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    joined, starts = _segments(ent)
    work = [np.ascontiguousarray(c) for c in coefs]
    if arith:
        rc = _arith_scan(joined, starts, work, geom, luts, cond, mcus_x, mcus_y, ss, se, ah, al,
                         restart, _NATURAL)
    else:
        rc = _decode_scan(joined + bytes(_SCAN_PAD), starts, work, geom, luts,
                          mcus_x, mcus_y, ss, se, ah, al, restart)
    if rc:
        raise ValueError(f"{name}: " + _SCAN_ERRORS[rc])
    for c, w in zip(coefs, work):
        c[...] = w


def _scan_lossless(header: bytes, ent: bytes, frame, comps, huff, restart, name):
    """Parse a lossless SOS header (Ss the predictor, Al the point
    transform) and decode its data into the components' samples."""
    sel, (ss, se, a) = _scan_components(header, comps, name)
    ah, al = a >> 4, a & 15
    if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= 8:  # jdlossls.c start_input_pass
        raise ValueError(f"{name}: bad lossless JPEG scan (predictor {ss}, Se {se}, Ah {ah}, Pt {al})")
    ns = len(sel)
    luts, planes, geom, rows = [], [], [], []
    for c, td, _ in sel:
        if (0, td) not in huff:
            raise ValueError(f"{name}: JPEG Huffman table {(0, td)} is missing")
        luts.append(huff[(0, td)])
        planes.append(c["samples"])
        geom.append((1, 1) if ns == 1 else (c["h"], c["v"]))
        rows.append(c["v"])
    if ns == 1:
        mcus_x, mcus_y = sel[0][0]["w"], sel[0][0]["hgt"]
    elif sum(h * v for h, v in geom) > 10:
        raise ValueError(f"{name}: JPEG scan of {sum(h * v for h, v in geom)} samples an MCU "
                         "(libjpeg takes at most 10)")
    else:
        mcus_x, mcus_y = -(-frame["wid"] // frame["hmax"]), -(-frame["hgt"] // frame["vmax"])
    if restart % mcus_x:  # jdlossls.c: restarts at whole MCU rows only
        raise ValueError(f"{name}: lossless JPEG restart interval {restart} is not a multiple of "
                         f"the {mcus_x} MCUs in a row")
    joined, starts = _segments(ent)
    rc = _lossless_scan(joined + bytes(_SCAN_PAD), starts, planes, geom, luts, rows,
                        mcus_x, mcus_y, ss, al, restart)
    if rc:
        raise ValueError(f"{name}: " + _SCAN_ERRORS[rc])


# --- encode ---


def jpeg_quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """jcparam.c jpeg_set_quality(quality, force_baseline=TRUE): the Annex K
    tables scaled by jpeg_quality_scaling, clamped to 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in _STD_QUANT)


def _encode_scan(*args) -> bytes:
    if native.available():
        return native.jpeg_encode_scan(*args)
    return _encode_scan_py(*args)


def encode_jpeg(rgb8: np.ndarray, quality: int) -> bytes:
    """8-bit RGB ``[H, W, 3]`` -> the JPEG file Pillow writes for
    ``Image.fromarray(rgb8, "RGB").save(f, "JPEG", quality=quality)``:
    JFIF, baseline, 4:2:0, no restart markers, the standard Huffman
    tables."""
    rgb8 = np.asarray(rgb8, np.uint8)
    hgt, wid = rgb8.shape[:2]
    mx, my = -(-wid // 16), -(-hgt // 16)
    y, cb, cr = _rgb_to_ycc(rgb8)
    qtabs = jpeg_quant_tables(quality)
    # Y (jcsample.c fullsize_downsample): the edge replicated out to whole
    # blocks; the last odd block column / row of an MCU is a dummy block
    # (jccoefct.c: zero AC, the DC of the block left of it, or above-right
    # of it in a dummy row)
    ybw, ybh = -(-wid // 8), -(-hgt // 8)
    yq = _fdct_quantize(_blocks(_pad_edge(y, ybh * 8, ybw * 8), ybh, ybw), qtabs[0])
    yq = yq.reshape(ybh, ybw, 64)
    ygrid = np.zeros((2 * my, 2 * mx, 64), np.int16)
    ygrid[:ybh, :ybw] = yq
    if ybw % 2:
        ygrid[:ybh, ybw, 0] = yq[:, -1, 0]
    if ybh % 2:
        ygrid[ybh, :, 0] = ygrid[ybh - 1, 1::2, 0].repeat(2)
    # chroma (h2v2_downsample): rows padded to even, columns to the output
    # width, 2x2 means with the bias 1, 2, 1, 2, ... along each row, then
    # the last row replicated to whole blocks
    chroma = []
    for plane in (cb, cr):
        p = _pad_edge(plane, hgt + hgt % 2, 16 * mx).astype(np.int32)
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        bias = np.tile(np.array([1, 2], np.int32), 4 * mx)
        d = ((s + bias) >> 2).astype(np.uint8)
        chroma.append(_fdct_quantize(_blocks(_pad_edge(d, 8 * my, 8 * mx), my, mx), qtabs[1]))
    # MCU order: Y00 Y01 Y10 Y11 Cb Cr
    ymcu = ygrid.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    blocks = np.concatenate([ymcu, chroma[0].reshape(my, mx, 1, 64),
                             chroma[1].reshape(my, mx, 1, 64)], axis=2).reshape(-1, 64)
    sel = np.tile(np.array([0, 0, 0, 0, 1, 2], np.int32), mx * my)
    tabs = [_encode_table(*_STD_HUFF[k]) for k in ("dc0", "ac0", "dc1", "ac1", "dc1", "ac1")]
    ent = _encode_scan(blocks, sel, [t[0] for t in tabs], [t[1] for t in tabs])

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    dqt = b"".join(seg(0xDB, bytes([i]) + t[_ZIGZAG].astype(np.uint8).tobytes())
                   for i, t in enumerate(qtabs))
    sof = seg(0xC0, struct.pack(">BHHB", 8, hgt, wid, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    dht = b"".join(seg(0xC4, bytes([cls << 4 | tid]) + bytes(_STD_HUFF[k][0]) + _STD_HUFF[k][1])
                   for cls, tid, k in ((0, 0, "dc0"), (1, 0, "ac0"), (0, 1, "dc1"), (1, 1, "ac1")))
    sos = seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return b"\xff\xd8" + _JFIF_APP0 + dqt + sof + dht + sos + ent + b"\xff\xd9"


# --- formats ---

JPEG_QUALITY = 75  # Pillow's default, what ``Image.save("x.jpg")`` writes
# Pillow's extension table for the formats the port writes (Image.EXTENSION)
_WRITERS = {".png": "png", ".apng": "png", ".jpg": "jpeg", ".jpeg": "jpeg", ".jpe": "jpeg",
            ".jfif": "jpeg", ".tif": "tiff", ".tiff": "tiff", ".gif": "gif", ".bmp": "bmp",
            ".dib": "dib", ".ppm": "ppm", ".pnm": "ppm", ".pgm": "ppm", ".pbm": "ppm",
            ".pfm": "ppm", ".tga": "tga", ".icb": "tga", ".vda": "tga", ".vst": "tga", ".webp": "webp"}
_ENCODERS = {"png": encode_png, "jpeg": lambda rgb8: encode_jpeg(rgb8, JPEG_QUALITY),
             "tiff": tiff.encode_tiff, "gif": gif.encode_gif, "bmp": bmp.encode_bmp,
             "dib": lambda rgb8: bmp.encode_bmp(rgb8, file_header=False), "ppm": netpbm.encode_ppm,
             "tga": tga.encode_tga, "webp": webp.encode_webp}
# Formats Pillow opens that the port does not read, told by their magic
# numbers and tried where Pillow's plugin order (after its preloaded BMP, DIB,
# GIF, JPEG, PPM and PNG) puts them: before TIFF, between TIFF and TGA. (ICO
# and CUR are left out: their four bytes also begin TGA files.)
_BEFORE_TIFF = (
    ("AVIF", lambda d: d[4:12] in (b"ftypavif", b"ftypavis")),
    ("BLP", lambda d: d[:4] in (b"BLP1", b"BLP2")),
    ("DDS", lambda d: d[:4] == b"DDS "),
    ("FITS", lambda d: d[:6] == b"SIMPLE"),
    ("ICNS", lambda d: d[:4] == b"icns"),
    ("JPEG 2000", lambda d: d[:4] == b"\xff\x4f\xff\x51" or d[:12] == b"\0\0\0\x0cjP  \r\n\x87\n"),
)
_BEFORE_TGA = (
    ("PSD", lambda d: d[:4] == b"8BPS"),
    ("QOI", lambda d: d[:4] == b"qoif"),
    ("SGI", lambda d: d[:2] == b"\x01\xda"),
    ("Sun raster", lambda d: d[:4] == b"\x59\xa6\x6a\x95"),
)


def _unsupported(data: bytes, name: str, table) -> None:
    for fmt, match in table:
        if match(data):
            raise ValueError(f"{name}: {fmt} file; the port does not read {fmt} "
                             "(ROADMAP.md queues the formats still to port)")


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An image file's bytes -> uint8 RGB ``[H, W, 3]``, the format told by
    its first bytes in the order ``Image.open`` tries Pillow's plugins: BMP,
    DIB (a header size of 12, 40, 52, 56, 64, 108 or 124 bytes), GIF, JPEG,
    the PPM family, PNG (APNG: its default image), then TIFF, TGA (by
    Pillow's TGA header checks) and WebP. A file in another format Pillow
    opens raises ``ValueError`` naming it; one no format claims raises
    too."""
    if data[:2] == bmp.SIGNATURE:
        return bmp.decode_bmp(data, name)
    if len(data) >= 4 and struct.unpack("<I", data[:4])[0] in bmp.DIB_HEADERS:
        return bmp.decode_dib(data, name)
    if data[:6] in gif.SIGNATURES:
        return gif.decode_gif(data, name)
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data, name)
    if netpbm.accepts(data[:2]):
        return netpbm.decode_pnm(data, name)
    if data[:8] == _PNG_SIGNATURE:
        return decode_png(data, name)
    _unsupported(data, name, _BEFORE_TIFF)
    if data[:4] in tiff.SIGNATURES:
        return tiff.decode_tiff(data, name)
    _unsupported(data, name, _BEFORE_TGA)
    if tga.accepts(data):
        return tga.decode_tga(data, name)
    if webp.accepts(data):
        return webp.decode_webp(data, name)
    raise ValueError(f"{name}: not an image file the port reads (PNG, JPEG, TIFF, GIF, BMP, DIB, "
                     "PBM/PGM/PPM/PFM, TGA, WebP)")


def image_format(path) -> str:
    """The format ``Image.save(path)`` picks from the extension
    (case-insensitive): ``png``, ``jpeg``, ``tiff``, ``gif``, ``bmp``,
    ``dib``, ``ppm``, ``tga`` or ``webp``. Raises ``ValueError`` naming any
    other extension."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext not in _WRITERS:
        raise ValueError(f"unknown file extension: {ext!r} ({path}); the port writes "
                         + ", ".join(_WRITERS))
    return _WRITERS[ext]


def write_image(path, rgb8: np.ndarray) -> None:
    """Write uint8 RGB ``[H, W, 3]`` in the format of the extension, the
    bytes Pillow's ``Image.fromarray(rgb8, "RGB").save(path)`` writes (PNG:
    the port's own encoder; JPEG at Pillow's default quality; WebP: lossy at
    Pillow's quality 80 in Pillow's layout, with the port's own VP8 frame,
    which Pillow reads to the pixels the port reads)."""
    data = _ENCODERS[image_format(path)](np.ascontiguousarray(rgb8, np.uint8))
    with open(path, "wb") as f:
        f.write(data)
