"""Owen-scrambled, shuffled 2-D Sobol sampling for sub-pixel jitter,
bit-exact with ``path_tracer_tpu/core/sobol.py`` (the reference sampler
``src/sampling.rs``).

u32 words live in int64 tensors, masked to 32 bits after every ``+``, ``*``
and ``<<`` (see `core.rng`).
"""

from __future__ import annotations

import torch

from path_tracer_tpu_torch.core.rng import MASK32, as_u32

# Direction numbers for the second Sobol dimension (src/sampling.rs:4-8).
DIRECTIONS = (
    0x80000000, 0xC0000000, 0xA0000000, 0xF0000000, 0x88000000, 0xCC000000,
    0xAA000000, 0xFF000000, 0x80800000, 0xC0C00000, 0xA0A00000, 0xF0F00000,
    0x88880000, 0xCCCC0000, 0xAAAA0000, 0xFFFF0000, 0x80008000, 0xC000C000,
    0xA000A000, 0xF000F000, 0x88008800, 0xCC00CC00, 0xAA00AA00, 0xFF00FF00,
    0x80808080, 0xC0C0C0C0, 0xA0A0A0A0, 0xF0F0F0F0, 0x88888888, 0xCCCCCCCC,
    0xAAAAAAAA, 0xFFFFFFFF,
)


def reverse_bits(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse each u32 (Rust ``u32::reverse_bits``)."""
    x = as_u32(x)
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & MASK32


def sobol_y(index: torch.Tensor) -> torch.Tensor:
    """Second-dimension Sobol point via direction-number XOR fold
    (src/sampling.rs:24-30)."""
    index = as_u32(index)
    out = torch.zeros_like(index)
    for bit, direction in enumerate(DIRECTIONS):
        out = out ^ (((index >> bit) & 1) * direction)
    return out


def lk_hash(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Improved Laine-Karras permutation hash (src/sampling.rs:53-68)."""
    x = as_u32(x)
    seed = as_u32(seed)
    x = x ^ ((x * 0x3D20ADEA) & MASK32)
    x = (x + seed) & MASK32
    x = (x * ((seed >> 16) | 1)) & MASK32
    x = x ^ ((x * 0x05526C56) & MASK32)
    x = x ^ ((x * 0x53A22864) & MASK32)
    return x


def scramble_base2(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Owen-style base-2 scramble: reverse, LK-hash, reverse
    (src/sampling.rs:71)."""
    return reverse_bits(lk_hash(reverse_bits(x), seed))


def low_bias_hash(x: torch.Tensor) -> torch.Tensor:
    """2-round low-bias integer hash used to derive seeds
    (src/sampling.rs:76-91)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & MASK32
    x = x ^ (x >> 15)
    x = (x * 0xD35A2D97) & MASK32
    x = x ^ (x >> 15)
    return x


def get_ss_sobol(index: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Shuffled, Owen-scrambled 2-D Sobol point in the unit square
    (``SobolSampler::get_ss_sobol``, src/sampling.rs:97-114). ``index`` and
    ``seed`` broadcast; returns ``broadcast + (2,)`` float32."""
    index, seed = torch.broadcast_tensors(as_u32(index), as_u32(seed))

    x_seed = low_bias_hash(seed)
    y_seed = low_bias_hash(seed + 1)
    shuffle_seed = low_bias_hash(seed + 2)

    shuffled_index = scramble_base2(index, shuffle_seed)

    sx = reverse_bits(shuffled_index)
    sy = sobol_y(shuffled_index)

    x = scramble_base2(sx, x_seed)
    y = scramble_base2(sy, y_seed)

    inv = 1.0 / 4294967295.0  # 1 / u32::MAX, matching sampling.rs:109
    return torch.stack([x.to(torch.float32) * inv, y.to(torch.float32) * inv], dim=-1)
