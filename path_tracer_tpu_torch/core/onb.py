"""Orthonormal bases from normals, batched (port of
``path_tracer_tpu/core/onb.py``; reference
``src/tlas/tlas_bvh/blas/primitive/material/onb.rs``).

``generate_onb`` is glam's ``any_orthonormal_pair`` (Duff et al. 2017);
BSDF sampling happens in this frame.
"""

from __future__ import annotations

import torch


def generate_onb(normal: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` unit normals -> ``[..., 3, 3]`` with COLUMNS
    (t0, t1, normal)."""
    x, y, z = normal[..., 0], normal[..., 1], normal[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = x * y * a
    c0 = torch.stack([1.0 + sign * x * x * a, sign * b, -sign * x], dim=-1)
    c1 = torch.stack([b, sign + y * y * a, -y], dim=-1)
    return torch.stack([c0, c1, normal], dim=-1)


def generate_onb_ggx(v: torch.Tensor) -> torch.Tensor:
    """GGX VNDF basis (``onb.rs:9-27``) with the z-up singularity guard at
    ``v.z > 0.99999``. Columns are (t1, t2, v)."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    t1_len = torch.sqrt(vx * vx + vy * vy)
    inv = 1.0 / torch.clamp(t1_len, min=1e-20)
    singular = vz > 0.99999
    t1x = torch.where(singular, 1.0, vy * inv)
    t1y = torch.where(singular, 0.0, -vx * inv)
    t2x = torch.where(singular, 0.0, t1y * vz)
    t2y = torch.where(singular, -1.0, -t1x * vz)
    t2z = torch.where(singular, 0.0, t1x * vy - t1y * vx)
    t1 = torch.stack([t1x, t1y, torch.zeros_like(t1x)], dim=-1)
    t2 = torch.stack([t2x, t2y, t2z], dim=-1)
    return torch.stack([t1, t2, v], dim=-1)


def onb_apply(onb: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``onb @ v``: tangent -> world, as a sum of scaled columns."""
    return (
        onb[..., :, 0] * v[..., 0:1]
        + onb[..., :, 1] * v[..., 1:2]
        + onb[..., :, 2] * v[..., 2:3]
    )


def onb_apply_transpose(onb: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``onb^T @ v``: world -> tangent."""
    return (
        onb[..., 0, :] * v[..., 0:1]
        + onb[..., 1, :] * v[..., 1:2]
        + onb[..., 2, :] * v[..., 2:3]
    )
