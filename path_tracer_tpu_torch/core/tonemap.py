"""Uchimura "Gran Turismo" filmic tonemap (port of
``path_tracer_tpu/core/tonemap.py``; reference
``src/image_helper/tonemapping.rs:2-113``)."""

from __future__ import annotations

import torch


def _smoothstep01(x, e0, e1):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def gt_tonemap(
    x: torch.Tensor,
    p: float = 1.0,
    a: float = 1.0,
    m: float = 0.22,
    l: float = 0.4,  # noqa: E741 — parameter name from the original paper
    c: float = 1.33,
    b: float = 0.0,
) -> torch.Tensor:
    """Per-channel Gran Turismo curve; negative inputs map to ``b``."""
    l0 = (p - m) * l / a

    w0 = 1.0 - _smoothstep01(x, 0.0, m)  # toe weight
    w2 = torch.where(x > m + l0, 1.0, 0.0)  # shoulder weight (step)
    w1 = 1.0 - w0 - w2  # linear weight

    toe = m * torch.pow(torch.clamp(x, min=0.0) / m, c) + b
    linear = m + a * (x - m)
    s1 = m + a * l0
    c2 = a * p / (p - s1)
    shoulder = p - (p - s1) * torch.exp(-c2 * (x - (m + l0)) / p)

    out = toe * w0 + linear * w1 + shoulder * w2
    return torch.where(x < 0.0, b, out)


def tonemap_to_srgb(rgb_linear: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Linear HDR RGB -> tonemapped gamma-encoded [0,1]
    (``src/image_helper.rs:44``)."""
    tm = gt_tonemap(rgb_linear)
    return torch.pow(torch.clamp(tm, min=0.0), 1.0 / gamma)
