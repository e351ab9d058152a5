"""TGA (Truevision Targa), read and written without Pillow, to Pillow's
bytes.

* `decode_tga`: as ``Image.open(...).convert("RGB")`` shows it (Pillow's
  ``TgaImagePlugin``): image types 1, 2 and 3 and their run-length forms
  9, 10 and 11; colour-mapped images with 16, 24 or 32-bit map entries;
  8-bit gray, 16-bit gray with alpha, 1-bit black and white; 16-bit
  (5-5-5, the top bit alpha), 24 and 32-bit true colour; both row orders and
  the right-to-left flag of the descriptor. A run packet may not cross a
  row's end (Pillow raises); a raw packet may.
* `accepts`: Pillow's header checks, the only way it tells a TGA file
  (the format has no magic number).
* `encode_tga`: the file ``Image.fromarray(rgb8, "RGB").save(path)`` writes
  for ``.tga``, ``.icb``, ``.vda`` and ``.vst``: type 2, 24-bit, bottom-up,
  uncompressed, with the version 2 footer.

The run-length loop runs in `native` (host C++) where g++ built it, else in
`_rle_decode_py`, which gives the same output.
"""

from __future__ import annotations

import struct

import numpy as np

from path_tracer_tpu_torch import native

_FOOTER = b"\0" * 8 + b"TRUEVISION-XFILE.\0"
_DEPTHS = {(1, 8), (3, 1), (3, 8), (3, 16), (2, 16), (2, 24), (2, 32)}  # (type & 7, bits) Pillow reads


def accepts(data: bytes) -> bool:
    """TgaImageFile._open's checks on the 18-byte header: colour map type 0
    or 1, a nonzero size, a depth of 1, 8, 16, 24 or 32 bits, an image type
    of 1, 2, 3, 9, 10 or 11, a known origin, and (with a map) a map depth of
    16, 24 or 32."""
    if len(data) < 18:
        return False
    cmap_type, kind, depth, flags = data[1], data[2], data[16], data[17]
    w, h = struct.unpack("<HH", data[12:16])
    return (cmap_type in (0, 1) and w > 0 and h > 0 and depth in (1, 8, 16, 24, 32)
            and kind in (1, 2, 3, 9, 10, 11) and (not cmap_type or data[7] in (16, 24, 32)))


def _rle_decode_py(data: bytes, depth: int, row_bytes: int, rows: int) -> tuple[bytes, int]:
    """TgaRleDecode.c's packets of ``depth``-byte pixels -> (the bytes of
    at most ``rows`` rows, 0, or -1 for a run that crosses a row's end)."""
    out, i, cap = bytearray(), 0, row_bytes * rows
    while len(out) < cap and i < len(data):
        k = depth * ((data[i] & 0x7F) + 1)
        if data[i] & 0x80:
            if i + 1 + depth > len(data):
                break
            if len(out) % row_bytes + k > row_bytes:
                return bytes(out), -1
            out += data[i + 1:i + 1 + depth] * (k // depth)
            i += 1 + depth
        else:
            if i + 1 + k > len(data):
                break
            out += data[i + 1:i + 1 + k][:cap - len(out)]
            i += 1 + k
    return bytes(out), 0


def _rle_decode(data, depth, row_bytes, rows):
    if native.available():
        return native.tga_rle_decode(data, depth, row_bytes, rows)
    return _rle_decode_py(data, depth, row_bytes, rows)


def _bgra15(v: np.ndarray) -> np.ndarray:
    """Pillow's ``BGRA;15Z`` unpacker, colour only: 5-bit fields scaled by
    ``x * 255 / 31``."""
    v = v.astype(np.int64)
    return np.stack([((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)], axis=-1).astype(np.uint8)


def decode_tga(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A TGA file's bytes -> uint8 RGB ``[H, W, 3]``, Pillow's
    ``Image.open(...).convert("RGB")``. Raises ``ValueError`` naming
    ``name``."""
    if not accepts(data):
        raise ValueError(f"{name}: not a TGA file")
    id_len, cmap_type, kind = data[0], data[1], data[2]
    first, length, map_depth = struct.unpack("<HHB", data[3:8])
    w, h, depth, flags = struct.unpack("<HHBB", data[12:18])
    if (flags & 0x30) not in (0x00, 0x10, 0x20, 0x30):
        raise ValueError(f"{name}: unknown TGA orientation")
    if (kind & 7, depth) not in _DEPTHS or (kind & 7 == 1 and not cmap_type):
        raise ValueError(f"{name}: TGA image type {kind} at {depth} bits is not supported")
    if kind & 8 and depth == 1:
        raise ValueError(f"{name}: run-length TGA at 1 bit is not supported")
    pos = 18 + id_len
    lut = None
    if cmap_type:
        size = {16: 2, 24: 3, 32: 4}[map_depth]
        entries = data[pos:pos + size * length]
        pos += size * length
        if kind & 7 == 1:
            cmap = np.zeros((first + length, 3), np.uint8)
            raw = np.frombuffer(entries[:len(entries) // size * size], np.uint8).reshape(-1, size)
            if size == 2:
                cmap[first:first + len(raw)] = _bgra15(raw.view("<u2")[:, 0])
            else:
                cmap[first:first + len(raw)] = raw[:, 2::-1]
            lut = np.zeros((256, 3), np.uint8)  # an index past the map is black, as in Pillow
            lut[:min(len(cmap), 256)] = cmap[:256]
    bpp = max(depth // 8, 1)
    row_bytes = (w * depth + 7) // 8
    if kind & 8:
        raw, rc = _rle_decode(data[pos:], bpp, row_bytes, h)
        if rc:
            raise ValueError(f"{name}: TGA run crosses the end of a row")
    else:
        raw = data[pos:pos + row_bytes * h]
    if len(raw) < row_bytes * h:
        raise ValueError(f"{name}: TGA image data is truncated")
    rows = np.frombuffer(raw[:row_bytes * h], np.uint8).reshape(h, row_bytes)
    if depth == 1:
        px = np.repeat((np.unpackbits(rows, axis=1)[:, :w] * 255)[..., None], 3, axis=2)
    elif depth == 8:
        px = lut[rows] if lut is not None else np.repeat(rows[..., None], 3, axis=2)
    elif kind & 7 == 3:  # 16-bit gray with alpha
        px = np.repeat(rows.reshape(h, w, 2)[..., :1], 3, axis=2)
    elif depth == 16:
        px = _bgra15(rows.view("<u2"))
    else:
        px = rows.reshape(h, w, bpp)[..., 2::-1]
    if not flags & 0x20:
        px = px[::-1]
    if flags & 0x10:
        px = px[:, ::-1]
    return np.ascontiguousarray(px)


def encode_tga(rgb8: np.ndarray) -> bytes:
    """8-bit RGB ``[H, W, 3]`` -> the file Pillow writes for
    ``Image.fromarray(rgb8, "RGB").save(path)`` with a ``.tga`` path."""
    rgb8 = np.ascontiguousarray(rgb8, np.uint8)
    h, w = rgb8.shape[:2]
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0)
    return head + rgb8[::-1, :, ::-1].tobytes() + _FOOTER
