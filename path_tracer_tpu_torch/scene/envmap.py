"""Equirectangular environment maps: host loading and the device lookup
(port of ``path_tracer_tpu/scene/envmap.py``; reference
``src/image_helper.rs``).

Images load as gamma-2.2 and are linearized with ``pow(2.2)``
(``image_helper.rs:25-33``); misses shade through an equirectangular lookup
with wrap-around bilinear filtering (``image_helper.rs:61-88``,
direction -> uv at ``integrator.rs:258-259``).

The JAX package reads and writes images through Pillow, which the card's
machine does not have. `load_image` decodes the file by its first bytes,
in the order Pillow tries its plugins, through the port's own codecs
(`utils.imageio` and the format modules beside it) to the bytes of
Pillow's ``convert("RGB")``: PNG (every colour type, bit depth and
interlace; APNG's default image), JPEG (baseline, extended and progressive;
gray, YCbCr, RGB, CMYK and YCCK; every sampling libjpeg-turbo takes), TIFF
(strips and tiles; none, LZW, Deflate and PackBits; gray, RGB and palette),
GIF (frame 0), BMP and DIB, PBM/PGM/PPM and gray PFM, TGA, and WebP (lossy,
lossless, extended, an animation's frame 0). Gray above 8
bits (PNG, TIFF, PGM) keeps its high byte where Pillow clips to 255
(``ROADMAP.md``, known faults of the reference). Anything else raises,
naming the file. `save_image` writes by the extension, as
``Image.save(path)`` does, the bytes Pillow writes: ``.tif``/``.tiff``,
``.bmp``, ``.dib``, ``.ppm``/``.pnm``/``.pgm``/``.pbm``/``.pfm`` (P6),
``.tga``/``.icb``/``.vda``/``.vst``, ``.gif`` (Pillow's median-cut palette),
``.jpg``/``.jpeg``/``.jpe``/``.jfif`` (quality 75); ``.png`` and ``.apng``
as the port's PNG; ``.webp`` lossy at Pillow's quality 80 in Pillow's layout,
with the port's own VP8 frame (libwebp's bytes are not reproduced; its
decode of them is); any other extension raises.

The lookup fetches the four texels of the bilinear footprint with four row
gathers. The JAX package's quad table (each footprint in one 12-wide row,
one gather per lookup) is not ported: on an H100 it did not beat the four
gathers and cost four times the image's memory (``PERF.md`` §7).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from path_tracer_tpu_torch.utils.imageio import decode_image, decode_png, write_image  # noqa: F401


def load_image(path) -> np.ndarray:
    """Load an image file (any format `utils.imageio.decode_image` reads)
    into linear-RGB float32 ``[H, W, 3]`` (gamma 2.2 -> linear), as the JAX
    package's ``load_image`` does with Pillow."""
    with open(path, "rb") as f:
        rgb8 = decode_image(f.read(), str(path))
    data = np.asarray(rgb8, np.float32) / 255.0
    return np.power(data, 2.2).astype(np.float32)


def save_image(path, rgb01: np.ndarray) -> None:
    """Save a [0,1] float image ``[H, W, 3]`` as 8-bit RGB in the format of
    the extension (`utils.imageio.write_image`)."""
    write_image(path, np.clip(np.asarray(rgb01) * 255.0, 0, 255).astype(np.uint8))


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
