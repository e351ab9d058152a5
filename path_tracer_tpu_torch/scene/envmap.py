"""Equirectangular environment lookup for miss rays (port of the plain
bilinear path of ``path_tracer_tpu/scene/envmap.py``; reference
``src/image_helper.rs:61-88`` and ``integrator.rs:256-266``)."""

from __future__ import annotations

import math

import torch


def get_pixel_bilinear(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Wrap-around bilinear sample of ``image [H,W,3]`` at uv in [0,1]:
    texel coordinates ``u*W, v*H`` truncated, both axes wrap."""
    h, w = image.shape[0], image.shape[1]
    x = u * w
    y = v * h
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    xf = x - torch.floor(x)
    yf = y - torch.floor(y)
    flat = image.reshape(-1, 3)

    def pix(xi, yi):
        return flat.index_select(0, torch.remainder(yi, h) * w + torch.remainder(xi, w))

    c00 = pix(x0, y0)
    c01 = pix(x0, y0 + 1)
    c10 = pix(x0 + 1, y0)
    c11 = pix(x0 + 1, y0 + 1)
    wx = xf[..., None]
    wy = yf[..., None]
    return (1 - wx) * (1 - wy) * c00 + (1 - wx) * wy * c01 + wx * (1 - wy) * c10 + wx * wy * c11


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
