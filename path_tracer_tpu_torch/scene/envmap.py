"""Equirectangular environment maps: host loading and the device lookup
(port of ``path_tracer_tpu/scene/envmap.py``; reference
``src/image_helper.rs``).

Images load as gamma-2.2 and are linearized with ``pow(2.2)``
(``image_helper.rs:25-33``); misses shade through an equirectangular lookup
with wrap-around bilinear filtering (``image_helper.rs:61-88``,
direction -> uv at ``integrator.rs:258-259``).

The JAX package reads images through Pillow, which the card's machine does
not have: `load_image` decodes PNG itself with ``zlib`` and ``struct``
(colour types 0, 2, 3, 4 and 6 at 8 bits, every filter type), to the bytes
of Pillow's ``convert("RGB")``: palette entries expanded, gray replicated,
alpha dropped. Interlaced files, other bit depths and other formats (JPEG)
raise. `save_image` writes through the film's PNG writer.

The lookup fetches the four texels of the bilinear footprint with four row
gathers. The JAX package's quad table (each footprint in one 12-wide row,
one gather per lookup) is not ported: on an H100 it did not beat the four
gathers and cost four times the image's memory (``PERF.md`` §7).
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


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


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An 8-bit PNG file's bytes -> uint8 RGB ``[H, W, 3]``, equal to
    Pillow's ``Image.open(...).convert("RGB")``. Raises ``ValueError``
    naming ``name`` and what it lacks for anything else."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file (images load as PNG only; JPEG and other "
                         "formats are not supported)")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{name}: {depth}-bit PNG; only 8-bit PNG is supported")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG; only non-interlaced PNG is supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} is not a PNG colour type")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (w * bpp + 1):
        raise ValueError(f"{name}: PNG image data is truncated")
    rows = raw[: h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    types = rows[:, 0].astype(np.int32)
    if (types > 4).any():
        raise ValueError(f"{name}: unknown PNG filter type {int(types.max())}")
    px = _unfilter(rows[:, 1:].reshape(h, w, bpp), types, bpp)
    if ctype == 3:
        if px.size and int(px.max()) >= palette.shape[0]:
            raise ValueError(f"{name}: palette index outside the PLTE chunk")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def load_image(path) -> np.ndarray:
    """Load a PNG into linear-RGB float32 ``[H, W, 3]`` (gamma 2.2 ->
    linear), as the JAX package's ``load_image`` does with Pillow."""
    with open(path, "rb") as f:
        rgb8 = decode_png(f.read(), str(path))
    data = np.asarray(rgb8, np.float32) / 255.0
    return np.power(data, 2.2).astype(np.float32)


def save_image(path, rgb01: np.ndarray) -> None:
    """Save a [0,1] float image ``[H, W, 3]`` as an 8-bit PNG."""
    from path_tracer_tpu_torch.film.film import _png_bytes

    data = np.clip(np.asarray(rgb01) * 255.0, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(_png_bytes(np.ascontiguousarray(data)))


def _texel(u, v, h, w):
    """Texel coordinates (image_helper.rs:71-88): ``u*W, v*H`` truncated, no
    half-texel offset; the integer parts and the fractions."""
    x = u * w
    y = v * h
    return (torch.floor(x).to(torch.int64), torch.floor(y).to(torch.int64),
            x - torch.floor(x), y - torch.floor(y))


def _blend(c00, c01, c10, c11, xf, yf):
    wx = xf[..., None]
    wy = yf[..., None]
    return (1 - wx) * (1 - wy) * c00 + (1 - wx) * wy * c01 + wx * (1 - wy) * c10 + wx * wy * c11


def get_pixel_bilinear(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Wrap-around bilinear sample of ``image [H,W,3]`` at uv in [0,1]:
    texel coordinates ``u*W, v*H`` truncated, both axes wrap."""
    h, w = image.shape[0], image.shape[1]
    x0, y0, xf, yf = _texel(u, v, h, w)
    flat = image.reshape(-1, 3)

    def pix(xi, yi):
        return flat.index_select(0, torch.remainder(yi, h) * w + torch.remainder(xi, w))

    return _blend(pix(x0, y0), pix(x0, y0 + 1), pix(x0 + 1, y0), pix(x0 + 1, y0 + 1), xf, yf)


def sample_environment(image: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Radiance for miss rays ``[N, 3]`` -> linear RGB ``[N, 3]``, with
    ``u = atan2(x, z) / 2pi + 0.5``, ``v = -asin(y) / pi + 0.5``."""
    if image.shape[0] == 1 and image.shape[1] == 1:
        # constant background: bilinear of a constant is the constant
        return image[0, 0].expand(direction.shape[:-1] + (3,))
    d = direction
    u = torch.atan2(d[..., 0], d[..., 2]) * (0.5 / math.pi) + 0.5
    v = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) * (-1.0 / math.pi) + 0.5
    return get_pixel_bilinear(image, u, v)
