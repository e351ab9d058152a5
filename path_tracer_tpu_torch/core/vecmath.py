"""Batched 3-vector math on ``[..., 3]`` tensors (port of
``path_tracer_tpu/core/vecmath.py``; reference ``src/utility.rs:7-36``).

Dots are written out componentwise in the JAX version's expression order, so
both packages round the same way.
"""

from __future__ import annotations

import math

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis (componentwise, left to right)."""
    out = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        out = out + a[..., i] * b[..., i]
    return out


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product over the last axis."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def length_sq(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_sq(a))


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize along the last axis. With ``eps=0`` a zero vector yields NaN,
    matching glam's ``normalize``."""
    n = length(a)[..., None]
    if eps:
        n = torch.clamp(n, min=eps)
    return a / n


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of ``i`` about ``n`` (``src/utility.rs:21``)."""
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Snell refraction. Returns ``(refracted, tir)``; the direction on TIR
    lanes is garbage and must be masked off (``src/utility.rs:23-36``)."""
    eta_e = eta[..., None] if eta.dim() == i.dim() - 1 else eta
    n_dot_i = dot(n, i)
    k = 1.0 - eta_e[..., 0] ** 2 * (1.0 - n_dot_i * n_dot_i)
    tir = k <= 0.0
    k_safe = torch.clamp(k, min=0.0)
    refracted = eta_e * i - (eta_e[..., 0] * n_dot_i + torch.sqrt(k_safe))[..., None] * n
    return refracted, tir


def random_cosine_vector(u0: torch.Tensor, u1: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere sample in tangent space (z-up),
    ``src/utility.rs:7-19``."""
    r = torch.sqrt(u0)
    z = torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))
    phi = (2.0 * math.pi) * u1
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1)


def ray_at(origin: torch.Tensor, direction: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Point along a ray (``src/ray.rs:20``)."""
    return origin + direction * t[..., None]


def transform_point(mat: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a ``[3, 4]`` affine matrix (rotation | translation) to points
    (``Affine3A::transform_point3a``)."""
    return p @ mat[:, :3].T + mat[:, 3]


def transform_vector(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply only the linear part of a ``[3, 4]`` affine matrix to vectors
    (``Affine3A::transform_vector3a``)."""
    return v @ mat[:, :3].T
