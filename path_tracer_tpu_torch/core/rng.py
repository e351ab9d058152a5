"""Counter-based, order-invariant RNG: ``pcg4d`` (Jarzynski & Olano, JCGT
2020), bit-exact with ``path_tracer_tpu/core/rng.py``.

Values depend only on (lane, sample, bounce, draw site), so any tiling of
the film renders the same image. The JAX version computes in uint32; torch
has no uint32 ``+`` or ``>>`` on the CPU, so here every word lives in int64
and is masked to 32 bits after each ``+``, ``*`` and ``<<``. An int64
product of two 32-bit values may wrap, but its low 32 bits are still the
uint32 product.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# 1 / 2^24, scaling 24 high bits into [0, 1). f32 holds all 2^24 values.
_INV_24 = 1.0 / 16777216.0


def as_u32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """Int64 tensor holding ``x`` modulo 2^32 (``x`` may be a Python int)."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=torch.int64, device=None if like is None else like.device)
    return x.to(torch.int64) & MASK32


def pcg4d(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor):
    """pcg4d hash of four u32-valued int64 tensors -> four (same shape)."""
    v0 = (as_u32(a) * 1664525 + 1013904223) & MASK32
    v1 = (as_u32(b) * 1664525 + 1013904223) & MASK32
    v2 = (as_u32(c) * 1664525 + 1013904223) & MASK32
    v3 = (as_u32(d) * 1664525 + 1013904223) & MASK32

    v0 = (v0 + v1 * v3) & MASK32
    v1 = (v1 + v2 * v0) & MASK32
    v2 = (v2 + v0 * v1) & MASK32
    v3 = (v3 + v1 * v2) & MASK32

    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)

    v0 = (v0 + v1 * v3) & MASK32
    v1 = (v1 + v2 * v0) & MASK32
    v2 = (v2 + v0 * v1) & MASK32
    v3 = (v3 + v1 * v2) & MASK32
    return v0, v1, v2, v3


def u32_to_unit_float(x: torch.Tensor) -> torch.Tensor:
    """u32 -> f32 in [0, 1) using the top 24 bits."""
    return (x >> 8).to(torch.float32) * _INV_24


def uniform4(lane_id: torch.Tensor, sample_id, bounce, stream) -> torch.Tensor:
    """Four independent U[0,1) floats per lane, shape ``lane_id.shape + (4,)``.

    ``sample_id``/``bounce``/``stream`` are tensors broadcastable to
    ``lane_id`` or Python ints."""
    shp = lane_id.shape
    b = as_u32(sample_id, lane_id).expand(shp)
    c = as_u32(bounce, lane_id).expand(shp)
    d = as_u32(stream, lane_id).expand(shp)
    r = pcg4d(lane_id, b, c, d)
    return torch.stack([u32_to_unit_float(x) for x in r], dim=-1)


class StreamCounter:
    """Hands out distinct stream ids for the RNG draw sites of a bounce, so
    that every `uniform4` call in it draws from its own stream."""

    def __init__(self, start: int = 0):
        self._next = start

    def next(self) -> int:
        v = self._next
        self._next += 1
        return v
