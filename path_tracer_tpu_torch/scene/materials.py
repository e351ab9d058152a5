"""Material system: host-side description -> packed SoA device table.

Host copy of ``path_tracer_tpu/scene/materials.py``; only
`unpack_material_rows` works on torch tensors.

The reference dispatches through a trait enum with five materials
(``src/tlas/tlas_bvh/blas/primitive/material.rs:80-89``): Lambertian, Emissive,
Specular, GGX (REFLECTIVE / TRANSMISSIVE sub-models) and Dielectric, plus
optional participating-media ``Volume`` attributes
(``.../material/volume.rs``). On TPU, materials become integer type codes and
a packed parameter table; the wavefront shading stage evaluates all material
models branchlessly and selects by code (no pointer dispatch).

Type codes (``MTYPE_*``): the GGX enum's two sub-models get distinct codes so
the shading kernels don't need a nested flag.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MTYPE_LAMBERTIAN = 0
MTYPE_EMISSIVE = 1
MTYPE_SPECULAR = 2
MTYPE_GGX_REFLECTIVE = 3
MTYPE_GGX_TRANSMISSIVE = 4
MTYPE_DIELECTRIC = 5

# Materials with delta (singular) distributions: Specular and Dielectric
# (material.rs:151, material.rs:494). GGX is never delta.
DELTA_TYPES = (MTYPE_SPECULAR, MTYPE_DIELECTRIC)


@dataclass(frozen=True)
class Volume:
    """Participating medium attached to a transmissive material
    (``volume.rs:116-143``).

    * ``absorption``/``k``: Beer-Lambert RGB absorption and extinction scale;
      the packed coefficient is ``absorption * k`` (``volume.rs:112``).
    * ``c``: scattering events per unit length (Henyey-Greenstein free flight).
    * ``g``: HG mean scattering cosine, clamped to ±0.999 (``volume.rs:27``).
    """

    absorption: tuple = (0.0, 0.0, 0.0)
    k: float = 0.0
    c: float = 0.0
    g: float = 0.0


@dataclass(frozen=True)
class Material:
    mtype: int
    colour: tuple = (0.0, 0.0, 0.0)
    emitted: tuple = (0.0, 0.0, 0.0)
    ggx_a: float = 0.0
    ior: float = 1.0
    volume: Volume | None = None


def Lambertian(albedo) -> Material:
    """Cosine-hemisphere diffuse (material.rs:91-116)."""
    return Material(MTYPE_LAMBERTIAN, colour=tuple(albedo))


def Emissive(emitted) -> Material:
    """Pure emitter (material.rs:118-136)."""
    return Material(MTYPE_EMISSIVE, emitted=tuple(emitted))


def Specular(colour) -> Material:
    """Delta mirror (material.rs:138-156)."""
    return Material(MTYPE_SPECULAR, colour=tuple(colour))


def _remap_roughness(roughness: float) -> float:
    # a = roughness^2 clamped to [1e-4, 0.9999] (material.rs:294, 309)
    return float(np.clip(roughness * roughness, 1e-4, 0.9999))


def GGXMetal(colour, roughness: float) -> Material:
    """GGX REFLECTIVE sub-model (material.rs:286-297)."""
    return Material(MTYPE_GGX_REFLECTIVE, colour=tuple(colour), ggx_a=_remap_roughness(roughness))


def GGXDielectric(colour, roughness: float, ior: float, volume: Volume | None = None) -> Material:
    """GGX TRANSMISSIVE sub-model: rough glass with refraction
    (material.rs:299-312)."""
    return Material(
        MTYPE_GGX_TRANSMISSIVE, colour=tuple(colour), ggx_a=_remap_roughness(roughness),
        ior=float(ior), volume=volume,
    )


def Dielectric(colour, ior: float, volume: Volume | None = None) -> Material:
    """Smooth glass: delta reflection/refraction with Schlick Fresnel + TIR
    (material.rs:464-530)."""
    return Material(MTYPE_DIELECTRIC, colour=tuple(colour), ior=float(ior), volume=volume)


def pack_materials(materials: list[Material]) -> dict[str, np.ndarray]:
    """Pack a material list into SoA arrays keyed by material id (list index).

    Volume semantics follow ``Volume::new`` (volume.rs:136-142): absorption is
    active iff ``k != 0``, scattering iff ``c != 0``. A material "has a volume"
    (pushed/popped on the integrator's medium stack) iff it was constructed
    with one — GGX transmissive or Dielectric with ``volume`` set
    (material.rs:452-459, 529).
    """
    n = len(materials)
    out = {
        "mtype": np.zeros(n, np.int32),
        "colour": np.zeros((n, 3), np.float32),
        "emitted": np.zeros((n, 3), np.float32),
        "ggx_a": np.zeros(n, np.float32),
        "ior": np.ones(n, np.float32),
        "is_delta": np.zeros(n, np.bool_),
        "is_emissive": np.zeros(n, np.bool_),
        "has_volume": np.zeros(n, np.bool_),
        "vol_absorption": np.zeros((n, 3), np.float32),  # absorption * k, pre-multiplied
        "vol_has_absorption": np.zeros(n, np.bool_),
        "vol_c": np.zeros(n, np.float32),
        "vol_g": np.zeros(n, np.float32),
        "vol_has_scatter": np.zeros(n, np.bool_),
    }
    for i, m in enumerate(materials):
        out["mtype"][i] = m.mtype
        # (row packing for the device table happens in pack_material_rows)
        out["colour"][i] = m.colour
        out["emitted"][i] = m.emitted
        out["ggx_a"][i] = m.ggx_a
        out["ior"][i] = m.ior
        out["is_delta"][i] = m.mtype in DELTA_TYPES
        out["is_emissive"][i] = m.mtype == MTYPE_EMISSIVE
        v = m.volume
        if v is not None and m.mtype in (MTYPE_GGX_TRANSMISSIVE, MTYPE_DIELECTRIC):
            out["has_volume"][i] = True
            if v.k != 0.0:
                out["vol_has_absorption"][i] = True
                out["vol_absorption"][i] = np.asarray(v.absorption, np.float32) * np.float32(v.k)
            if v.c != 0.0:
                out["vol_has_scatter"][i] = True
                out["vol_c"][i] = v.c
                out["vol_g"][i] = float(np.clip(v.g, -0.999, 0.999))
    return out


# Packed row layout for the device-side material table: one gather fetches
# every parameter a shading lane needs (see trace/gather.py for why).
MAT_ROW_W = 20
_MAT_COLS = {
    "mtype": (0, 1),
    "colour": (1, 4),
    "emitted": (4, 7),
    "ggx_a": (7, 8),
    "ior": (8, 9),
    "is_delta": (9, 10),
    "is_emissive": (10, 11),
    "has_volume": (11, 12),
    "vol_absorption": (12, 15),
    "vol_has_absorption": (15, 16),
    "vol_c": (16, 17),
    "vol_g": (17, 18),
    "vol_has_scatter": (18, 19),
}
_MAT_BOOL = {"is_delta", "is_emissive", "has_volume", "vol_has_absorption", "vol_has_scatter"}
_MAT_INT = {"mtype"}


def pack_material_rows(table: dict) -> np.ndarray:
    """SoA material dict (from `pack_materials`) -> ``[NM, MAT_ROW_W]`` f32."""
    n = table["mtype"].shape[0]
    rows = np.zeros((n, MAT_ROW_W), np.float32)
    for key, (lo, hi) in _MAT_COLS.items():
        v = np.asarray(table[key], np.float32)
        rows[:, lo:hi] = v if v.ndim == 2 else v[:, None]
    return rows


def unpack_material_rows(rows: torch.Tensor) -> dict:
    """Gathered ``[N, MAT_ROW_W]`` rows -> per-lane parameter dict (the
    interface `integrator.bsdf` consumes)."""
    out = {}
    for key, (lo, hi) in _MAT_COLS.items():
        v = rows[:, lo:hi]
        if hi - lo == 1:
            v = v[:, 0]
        if key in _MAT_BOOL:
            v = v > 0.5
        elif key in _MAT_INT:
            v = v.to(torch.int32)
        out[key] = v
    return out
