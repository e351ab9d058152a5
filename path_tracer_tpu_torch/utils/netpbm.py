"""The PPM family (PBM, PGM, PPM: P1-P6), read and written without Pillow,
to Pillow's bytes.

* `decode_pnm`: as ``Image.open(...).convert("RGB")`` shows it (Pillow's
  ``PpmImagePlugin``): ASCII (P1-P3) and binary (P4-P6), comments in the
  header and in ASCII data, a maxval other than 255 scaled by Python's
  ``round(v / maxval * 255)``, 16-bit binary samples. Gray with a maxval
  above 255 is Pillow's mode ``I`` (``round(v / maxval * 65535)``), which
  its ``convert("RGB")`` clips to 255; the port keeps that value's high
  byte instead, as for 16-bit gray PNG (``ROADMAP.md``, known faults of the
  reference). Gray PFM (``Pf``, Pillow's mode ``F``, rows bottom-up)
  converts as Pillow converts ``F``: clipped to 0..255 and truncated, NaN
  to 0; colour PFM (``PF``), which Pillow does not open, raises.
* `encode_ppm`: the file ``Image.fromarray(rgb8, "RGB").save(path)`` writes
  for ``.ppm``, ``.pnm``, ``.pgm`` and ``.pbm`` alike: binary P6.
"""

from __future__ import annotations

import numpy as np

_WHITESPACE = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB"}


def accepts(prefix: bytes) -> bool:
    """PpmImagePlugin._accept: ``P`` and one of ``0123456fy``."""
    return len(prefix) >= 2 and prefix[:1] == b"P" and prefix[1] in b"0123456fy"


def _header(data: bytes, name: str):
    """The magic number, the numeric tokens of the header and the position
    after the whitespace that ends the last one (PpmImageFile._open)."""
    magic, pos = b"", 0
    while pos < len(data) and len(magic) < 6:
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    if magic not in _MODES and magic != b"Pf":
        raise ValueError(f"{name}: PPM variant {magic!r} is not supported (P1-P6 are)")

    def token(kind=int):
        nonlocal pos
        tok = b""
        while len(tok) <= 10:
            c = data[pos:pos + 1]
            pos += 1
            if not c:
                break
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while data[pos:pos + 1] not in (b"\r", b"\n", b""):
                    pos += 1
                pos += 1
                continue
            tok += c
        if not tok:
            raise ValueError(f"{name}: PPM header ends early")
        if len(tok) > 10:
            raise ValueError(f"{name}: PPM header token too long")
        try:
            return kind(tok)
        except ValueError:
            raise ValueError(f"{name}: bad PPM header token {tok!r}") from None

    w, h = token(), token()
    if magic == b"Pf":
        scale = token(float)
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError(f"{name}: PFM scale must be finite and nonzero")
        maxval = -1 if scale < 0 else 1  # the sign: the byte order
    else:
        maxval = 1 if magic in (b"P1", b"P4") else token()
    if w <= 0 or h <= 0 or w * h > 2 * 89478485:
        raise ValueError(f"{name}: bad PPM image size {w}x{h}")
    if magic != b"Pf" and not 0 < maxval < 65536:
        raise ValueError(f"{name}: PPM maxval must be greater than 0 and less than 65536")
    return magic, w, h, maxval, pos


def _strip_comments(block: bytes) -> bytes:
    """PpmPlainDecoder._ignore_comments on the whole data: each ``#`` to
    the next CR or LF goes."""
    out, pos = [], 0
    while True:
        start = block.find(b"#", pos)
        if start < 0:
            out.append(block[pos:])
            return b"".join(out)
        out.append(block[pos:start])
        ends = [e for e in (block.find(b"\n", start), block.find(b"\r", start)) if e >= 0]
        if not ends:
            return b"".join(out)
        pos = min(ends) + 1


def _scale(v: np.ndarray, maxval: int, top: int) -> np.ndarray:
    """Python's ``round(v / maxval * top)`` (half to even, on the double)."""
    return np.rint(v.astype(np.float64) / maxval * top).astype(np.int64)


def decode_pnm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PBM, PGM or PPM file's bytes -> uint8 RGB ``[H, W, 3]``, Pillow's
    ``Image.open(...).convert("RGB")`` but for gray above 8 bits (the high
    byte, where Pillow clips). Raises ``ValueError`` naming ``name``."""
    if not accepts(data[:2]):
        raise ValueError(f"{name}: not a PBM, PGM or PPM file")
    magic, w, h, maxval, pos = _header(data, name)
    if magic == b"Pf":
        raw = data[pos:pos + 4 * w * h]
        if len(raw) < 4 * w * h:
            raise ValueError(f"{name}: PFM image data is truncated")
        f = np.frombuffer(raw, "<f4" if maxval < 0 else ">f4").reshape(h, w)[::-1]
        g = np.clip(np.nan_to_num(f.astype(np.float64), nan=0.0), 0, 255).astype(np.uint8)
        return np.repeat(g[..., None], 3, axis=2)
    mode = _MODES[magic]
    bands = 3 if mode == "RGB" else 1
    n = w * h * bands
    wide = mode == "L" and maxval > 255  # Pillow's mode I
    body = data[pos:]
    if magic == b"P4":
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise ValueError(f"{name}: PBM image data is truncated")
        bits = np.unpackbits(np.frombuffer(body[:stride * h], np.uint8).reshape(h, stride), axis=1)
        v = np.where(bits[:, :w] == 1, 0, 255).astype(np.uint8)
    elif magic == b"P1":
        digits = b"".join(_strip_comments(body).split())
        bad = digits.translate(None, b"01")
        if bad:
            raise ValueError(f"{name}: invalid PBM token {bad[:1]!r}")
        if len(digits) < w * h:
            raise ValueError(f"{name}: not enough PBM image data")
        v = np.where(np.frombuffer(digits[:w * h], np.uint8) == ord("1"), 0, 255).astype(np.uint8)
    elif magic in (b"P2", b"P3"):
        tokens = _strip_comments(body).split()[:n]
        if any(len(t) > 10 for t in tokens):
            raise ValueError(f"{name}: PPM data token too long")
        try:
            vals = np.array([int(t) for t in tokens], np.int64)
        except ValueError:
            raise ValueError(f"{name}: bad PPM data token") from None
        if len(vals) < n:
            raise ValueError(f"{name}: not enough PPM image data")
        if (vals < 0).any() or (vals > maxval).any():
            raise ValueError(f"{name}: PPM sample outside 0..maxval")
        v = _scale(vals, maxval, 65535 if wide else 255)
    else:
        size = 2 if maxval > 255 else 1
        raw = body[:n * size]
        if len(raw) < n * size:
            raise ValueError(f"{name}: PPM image data is truncated")
        vals = np.frombuffer(raw, ">u2" if size == 2 else np.uint8).astype(np.int64)
        if maxval == 255 or (wide and maxval == 65535):
            v = vals
        else:
            top = 65535 if wide else 255
            v = np.minimum(_scale(vals, maxval, top), top)
    v = np.asarray(v)
    if wide:
        v = v >> 8  # the 16-bit value's high byte (Pillow clips to 255)
    v = v.astype(np.uint8).reshape(h, w, bands)
    return np.ascontiguousarray(np.repeat(v, 3, axis=2) if bands == 1 else v)


def encode_ppm(rgb8: np.ndarray) -> bytes:
    """8-bit RGB ``[H, W, 3]`` -> the file Pillow writes for
    ``Image.fromarray(rgb8, "RGB").save(path)`` with a ``.ppm``, ``.pnm``,
    ``.pgm`` or ``.pbm`` path: P6, maxval 255."""
    rgb8 = np.ascontiguousarray(rgb8, np.uint8)
    h, w = rgb8.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + rgb8.tobytes()
