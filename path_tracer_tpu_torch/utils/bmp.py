"""BMP and DIB, read and written without Pillow, to Pillow's bytes.

* `decode_bmp`: as ``Image.open(...).convert("RGB")`` shows it (Pillow's
  ``BmpImagePlugin``): ``BITMAPCOREHEADER`` (OS/2 1.x) and
  ``BITMAPINFOHEADER`` v3, v4 and v5; 1, 4 and 8-bit palette images, 16
  (5-5-5), 24 and 32-bit images; ``BI_BITFIELDS`` at 16 bits (5-5-5 and
  5-6-5) and at the 32-bit masks Pillow knows; ``BI_RLE8`` and ``BI_RLE4``
  as Pillow's run-length decoder reads them (its delta escape and its odd
  RLE4 absolute runs included); bottom-up and top-down rows. A ``.dib``
  (no file header) is read by `decode_dib`.
* `encode_bmp`: the file ``Image.fromarray(rgb8, "RGB").save(path)`` writes
  for a ``.bmp`` (24-bit, ``BITMAPINFOHEADER``, 96 dpi, bottom-up), and
  without the file header for a ``.dib``.

The run-length loop runs in `native` (host C++) where g++ built it, else in
`_rle_decode_py`, which gives the same output.
"""

from __future__ import annotations

import struct

import numpy as np

from path_tracer_tpu_torch import native

SIGNATURE = b"BM"
DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)  # Pillow's DIB header sizes
_MASK_MODES = {  # (bits, masks) -> Pillow's raw mode (BmpImagePlugin MASK_MODES)
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)), (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)),
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)), (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)), (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)), (32, (0x0, 0x0, 0x0, 0x0)),
    (24, (0xFF0000, 0xFF00, 0xFF)), (16, (0xF800, 0x7E0, 0x1F)), (16, (0x7C00, 0x3E0, 0x1F)),
}


def _rle_decode_py(data: bytes, base: int, width: int, rle4: bool, size: int) -> tuple[np.ndarray, int]:
    """Pillow's ``BmpRleDecoder.decode`` loop on ``data`` (at file offset
    ``base``) -> (at most ``size`` indices in file row order, the count, or
    -1 where a delta escape's second pair is cut off)."""
    out = bytearray()
    i = x = 0
    while len(out) < size:
        if i + 2 > len(data):
            break
        num, byte = data[i], data[i + 1]
        i += 2
        if num:
            if x + num > width:
                num = max(0, width - x)
            if rle4:
                out += bytes((byte >> 4) if k % 2 == 0 else (byte & 15) for k in range(num))
            else:
                out += bytes([byte]) * num
            x += num
        elif byte == 0:
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:  # Pillow reads the two bytes after the escape, then two more
            if i + 2 > len(data):
                break
            i += 2
            if i + 2 > len(data):
                return np.zeros(0, np.uint8), -1
            right, up = data[i], data[i + 1]
            i += 2
            out += bytes(min(right + up * width, max(size - len(out), 0)))
            x = len(out) % width
        else:
            count = byte // 2 if rle4 else byte
            got = data[i:i + count]
            i += len(got)
            out += bytes(v for b in got for v in (b >> 4, b & 15)) if rle4 else got
            if len(got) < count:
                break
            x += byte
            if (base + i) % 2:
                i += 1
    n = min(len(out), size)
    return np.frombuffer(bytes(out[:n]), np.uint8), n


def _rle_decode(data, base, width, rle4, size):
    if native.available():
        return native.bmp_rle_decode(data, base, width, rle4, size)
    return _rle_decode_py(data, base, width, rle4, size)


def _channel(v: np.ndarray, mask: int) -> np.ndarray:
    """A masked channel of packed pixels, scaled to 8 bits as Pillow's
    unpackers scale 5 and 6-bit fields (``x * 255 / (2^n - 1)``)."""
    if not mask:
        return np.zeros(v.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    bits = (mask >> shift).bit_length()
    c = (v.astype(np.int64) & mask) >> shift
    if bits >= 8:
        return (c >> (bits - 8)).astype(np.uint8)
    return (c * 255 // ((1 << bits) - 1)).astype(np.uint8)


def _decode(data: bytes, header_at: int, offset: int, name: str) -> np.ndarray:
    """Pillow's ``BmpImageFile._bitmap`` from the info header at
    ``header_at``; ``offset`` the file header's data offset (0: the data
    follows the header and the palette)."""
    if len(data) < header_at + 4:
        raise ValueError(f"{name}: BMP header is truncated")
    (hsize,) = struct.unpack("<I", data[header_at:header_at + 4])
    if hsize not in DIB_HEADERS:
        raise ValueError(f"{name}: BMP header of {hsize} bytes is not supported")
    hd = data[header_at + 4:header_at + hsize]
    if len(hd) < hsize - 4:
        raise ValueError(f"{name}: BMP header is truncated")
    pos = header_at + hsize
    masks = None
    if hsize == 12:
        w, h, _, bits = struct.unpack("<HHHH", hd[:8])
        compression, colors, pad, top_down = 0, 0, 3, False
    else:
        top_down = hd[7] == 0xFF
        w, h = struct.unpack("<II", hd[:8])
        if top_down:
            h = 2 ** 32 - h
        bits, compression = struct.unpack("<HI", hd[10:16])
        (colors,) = struct.unpack("<I", hd[28:32])
        pad = 4
        if compression == 3:
            if len(hd) >= 48:
                masks = struct.unpack("<III", hd[36:48]) + (struct.unpack("<I", hd[48:52]) if len(hd) >= 52 else (0,))
            else:
                if len(data) < pos + 12:
                    raise ValueError(f"{name}: BMP bit masks are truncated")
                masks = struct.unpack("<III", data[pos:pos + 12]) + (0,)
                pos += 12
    if w <= 0 or h <= 0 or w * h > 2 * 89478485:
        raise ValueError(f"{name}: bad BMP image size {w}x{h}")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{name}: BMP pixel depth {bits} is not supported")
    if compression == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _MASK_MODES:
            raise ValueError(f"{name}: BMP bit field layout {masks} is not supported")
    elif compression in (1, 2):
        if bits > 8:
            raise ValueError(f"{name}: run-length BMP at {bits} bits is not supported")
    elif compression != 0:
        kind = {4: "JPEG", 5: "PNG"}.get(compression, f"compression {compression}")
        raise ValueError(f"{name}: {kind} BMP is not supported")
    lut = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: BMP palette of {colors} colours is not supported")
        palette = data[pos:pos + pad * colors]
        pos += len(palette)
        gray_idx = (0, 255) if colors == 2 else range(colors)
        gray = all(palette[i * pad:i * pad + 3] == bytes([v & 255]) * 3 for i, v in enumerate(gray_idx))
        lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        if gray:  # Pillow reads it as mode "1" (two colours) or "L": the index is the level
            if not ((colors == 2 and bits == 1 and compression == 0)
                    or (colors != 2 and (bits == 8 or compression in (1, 2)))):
                raise ValueError(f"{name}: {bits}-bit BMP with a {colors}-entry gray palette is "
                                 "not supported (Pillow misreads it)")
            if colors == 2:
                lut[1] = 255
        else:
            lut[:] = 0  # an index past the palette is black, as in Pillow
            entries = np.frombuffer(palette[:len(palette) // pad * pad], np.uint8).reshape(-1, pad)
            lut[:min(len(entries), 256)] = entries[:256, 2::-1]
    start = offset or pos
    if compression in (1, 2):
        idx, n = _rle_decode(data[start:], start, w, compression == 2, w * h)
        if n < w * h:
            raise ValueError(f"{name}: BMP run-length data is truncated")
        px = idx.reshape(h, w)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        rows = data[start:start + stride * h]
        if len(rows) < stride * h:
            raise ValueError(f"{name}: BMP image data is truncated")
        rows = np.frombuffer(rows, np.uint8).reshape(h, stride)
        if bits <= 8:
            px = np.unpackbits(rows, axis=1).reshape(h, -1, bits) @ (1 << np.arange(bits - 1, -1, -1))
            px = px[:, :w].astype(np.uint8)
        elif bits == 24:
            px = rows[:, :3 * w].reshape(h, w, 3)[..., ::-1]
        else:
            v = rows[:, :bits // 8 * w].view("<u2" if bits == 16 else "<u4").reshape(h, w)
            if masks is None:
                masks = (0x7C00, 0x3E0, 0x1F, 0) if bits == 16 else (0xFF0000, 0xFF00, 0xFF, 0)
            if masks[:3] == (0, 0, 0):
                masks = (0xFF0000, 0xFF00, 0xFF, 0)  # all-zero masks: Pillow's BGRA
            px = np.stack([_channel(v, m) for m in masks[:3]], axis=-1)
    if not top_down:
        px = px[::-1]
    if lut is not None:
        return lut[px]
    return np.ascontiguousarray(px)


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A BMP file's bytes -> uint8 RGB ``[H, W, 3]``, Pillow's
    ``Image.open(...).convert("RGB")``. Raises ``ValueError`` naming
    ``name``."""
    if data[:2] != SIGNATURE or len(data) < 14:
        raise ValueError(f"{name}: not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    return _decode(data, 14, offset, name)


def decode_dib(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A DIB (a BMP without its file header): Pillow's ``DibImageFile``."""
    return _decode(data, 0, 0, name)


def encode_bmp(rgb8: np.ndarray, file_header: bool = True) -> bytes:
    """8-bit RGB ``[H, W, 3]`` -> the file Pillow writes for
    ``Image.fromarray(rgb8, "RGB").save(path)`` with a ``.bmp`` path, or
    with a ``.dib`` path (``file_header=False``)."""
    rgb8 = np.ascontiguousarray(rgb8, np.uint8)
    h, w = rgb8.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb8[::-1, :, ::-1].reshape(h, 3 * w)
    ppm = int(96 * 39.3701 + 0.5)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, stride * h, ppm, ppm, 0, 0)
    head = b"BM" + struct.pack("<III", 54 + stride * h, 0, 54) if file_header else b""
    return head + info + rows.tobytes()
