"""WebP, read and written without Pillow, to Pillow's pixels.

* `decode_webp`: as ``Image.open(...).convert("RGB")`` shows it (Pillow's
  ``WebPImagePlugin``, which reads every file through libwebp's
  ``WebPAnimDecoder``): the ``RIFF``/``WEBP`` container with its chunk
  padding, in the simple lossy (``VP8 ``) and lossless (``VP8L``) layouts
  and the extended one (``VP8X``). ``ICCP``, ``EXIF``, ``XMP `` and unknown
  chunks are skipped (Pillow keeps them only in ``info``); ``ALPH`` is
  parsed and decoded, so a corrupt one raises as in libwebp, but leaves
  the RGB as it is (``convert("RGB")`` drops alpha, and the decoder does not
  premultiply). An animation (``ANIM`` + ``ANMF``) gives frame 0 as the
  animation decoder composes it: the frame at its offset (2X, 2Y) on a
  canvas of transparent black, so black around it (frame 0 is a key
  frame: nothing to blend). libwebp's demuxer checks hold: a truncated
  ``RIFF``, a chunk past its end, unknown ``VP8X`` flags, a still image
  whose size is not the canvas's, a frame outside the canvas, an ``ALPH``
  before ``VP8L`` raise ``ValueError`` naming the file.
* `encode_webp`: what ``Image.fromarray(rgb8, "RGB").save("x.webp")``
  writes: lossy at quality 80, the simple layout (``RIFF``/``WEBP``/
  ``VP8 `` and nothing else), with the port's own VP8 key frame
  (`vp8.encode_vp8`; Pillow's bytes come from libwebp's encoder and are
  not reproduced, its decode is: Pillow reads the port's file to the
  pixels the port reads).

The bitstreams are `vp8` (lossy) and `vp8l` (lossless).
"""

from __future__ import annotations

import struct

import numpy as np

from path_tracer_tpu_torch.utils import vp8, vp8l

_VALID_FLAGS = 0x3E  # VP8X: ICC, alpha, EXIF, XMP, animation


def accepts(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _chunks(data: bytes, start: int, end: int) -> list:
    """The chunks of ``data[start:end]`` as ``(fourcc, payload)``."""
    out, pos = [], start
    while pos < end:
        if pos + 8 > end:
            raise ValueError("truncated WebP chunk header")
        tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if pos + 8 + size > end:
            raise ValueError(f"WebP chunk {tag!r} is truncated")
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _le24(b: bytes) -> int:
    return b[0] | b[1] << 8 | b[2] << 16


def _size(tag: bytes, payload: bytes) -> tuple[int, int]:
    return vp8l.header(payload) if tag == b"VP8L" else vp8.header(payload)[:2]


def _check_alpha(alph: bytes, w: int, h: int) -> None:
    """ALPHDecode's header checks and the decode of a lossless alpha plane
    (its values are not kept: see the module docstring)."""
    if not alph:
        raise ValueError("ALPH: empty chunk")
    method, pre, reserved = alph[0] & 3, (alph[0] >> 4) & 3, alph[0] >> 6
    if method > 1 or pre > 1 or reserved:
        raise ValueError("ALPH: bad header")
    if method == 0:
        if len(alph) - 1 < w * h:
            raise ValueError("ALPH: truncated alpha plane")
    else:
        vp8l.decode_stream(alph[1:], w, h)


def _frame(image: tuple, alph: bytes | None) -> np.ndarray:
    """One image chunk (with the ``ALPH`` before it) -> uint8 RGB."""
    tag, payload = image
    if tag == b"VP8L":
        argb = vp8l.decode_vp8l(payload)
        return np.stack([(argb >> s) & 0xFF for s in (16, 8, 0)], axis=-1).astype(np.uint8)
    rgb = vp8.decode_vp8(payload)
    if alph is not None:
        _check_alpha(alph, rgb.shape[1], rgb.shape[0])
    return rgb


def _image_of(chunks: list) -> tuple:
    """The ``(ALPH payload or None, (fourcc, payload))`` of a frame's
    chunks: an optional ``ALPH``, then ``VP8 `` or ``VP8L``."""
    alph = None
    for tag, payload in chunks:
        if tag == b"ALPH":
            alph = payload if alph is None else alph
        elif tag in (b"VP8 ", b"VP8L"):
            if tag == b"VP8L" and alph is not None:
                raise ValueError("ALPH before a lossless image")
            return alph, (tag, payload)
    raise ValueError("WebP file without an image")


def decode_webp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A WebP file's bytes -> uint8 RGB ``[H, W, 3]``, Pillow's
    ``Image.open(...).convert("RGB")``. Raises ``ValueError`` naming
    ``name``."""
    try:
        return _decode(data)
    except ValueError as err:
        raise ValueError(f"{name}: {err}") from None


def _decode(data: bytes) -> np.ndarray:
    if len(data) < 12 or not accepts(data):
        raise ValueError("not a WebP file")
    riff = struct.unpack("<I", data[4:8])[0]
    if riff < 12:
        raise ValueError("bad RIFF size")
    if len(data) < 8 + riff:
        raise ValueError("truncated WebP file")
    chunks = _chunks(data, 12, 8 + riff)
    if not chunks:
        raise ValueError("WebP file without chunks")
    tag, payload = chunks[0]
    if tag in (b"VP8 ", b"VP8L"):
        return _frame((tag, payload), None)
    if tag != b"VP8X":
        raise ValueError(f"unknown WebP layout (first chunk {tag!r})")
    if len(payload) < 10:
        raise ValueError("VP8X chunk is truncated")
    flags = payload[0]
    cw, ch = _le24(payload[4:7]) + 1, _le24(payload[7:10]) + 1
    if flags & ~_VALID_FLAGS:
        raise ValueError("unknown VP8X flags")
    rest = chunks[1:]
    if not flags & 0x02:  # a still image
        if any(t in (b"ANIM", b"ANMF") for t, _ in rest):
            raise ValueError("animation chunks without the animation flag")
        alph, image = _image_of(rest)
        if _size(*image) != (cw, ch):
            raise ValueError("image size differs from the VP8X canvas")
        return _frame(image, alph)
    tags = [t for t, _ in rest]
    if b"ANIM" not in tags or b"ANMF" not in tags or tags.index(b"ANMF") < tags.index(b"ANIM"):
        raise ValueError("animation without ANIM and ANMF chunks in order")
    if any(t in (b"ALPH", b"VP8 ", b"VP8L") for t in tags):
        raise ValueError("image chunk outside an ANMF frame")
    if len(rest[tags.index(b"ANIM")][1]) < 6:
        raise ValueError("ANIM chunk is truncated")
    anmf = rest[tags.index(b"ANMF")][1]
    if len(anmf) < 16:
        raise ValueError("ANMF chunk is truncated")
    x, y = 2 * _le24(anmf[0:3]), 2 * _le24(anmf[3:6])
    alph, image = _image_of(_chunks(anmf, 16, len(anmf)))
    fw, fh = _size(*image)  # the bitstream's size, as the demuxer takes it
    if x + fw > cw or y + fh > ch:
        raise ValueError("frame 0 lies outside the canvas")
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[y:y + fh, x:x + fw] = _frame(image, alph)
    return canvas


def encode_webp(rgb8: np.ndarray, **options) -> bytes:
    """8-bit RGB ``[H, W, 3]`` -> a lossy WebP of quality 80 in Pillow's
    layout. ``options`` go to `vp8.encode_vp8` (its internal arguments, for
    the tests)."""
    frame = vp8.encode_vp8(rgb8, **options)
    chunk = b"VP8 " + struct.pack("<I", len(frame)) + frame + b"\0" * (len(frame) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
