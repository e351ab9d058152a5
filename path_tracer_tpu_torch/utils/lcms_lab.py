"""CIELab -> RGB as Pillow converts an image of mode ``LAB``
(``Image.convert("RGB")``): LittleCMS 2's transform from its built-in Lab
(D50) profile to its built-in sRGB profile, perceptual intent, 8 bits in
and out, which Pillow builds in ``ImageCms``.

LittleCMS optimizes that transform into a 33 x 33 x 33 CLUT of 16-bit
values, each node the float pipeline at the node's 16-bit input (V4 Lab ->
XYZ over 1 + 32767/32768, the inverse of sRGB's Bradford-adapted colorant
matrix scaled by the same, the inverse sRGB tone curve, each stage rounded
to float32, the result saturated to 16 bits), and interpolates it
tetrahedrally in 16.16 fixed point on the 8-bit input widened to 16 bits;
the 16-bit output is narrowed to 8 bits. `lab_to_rgb` does the same, and
equals Pillow 12.1.0 (LittleCMS 2.17) on all 2^24 inputs.
"""

from __future__ import annotations

import functools

import numpy as np

_D50 = (0.9642, 1.0, 0.8249)
_ADJ = 1 + 32767.0 / 32768.0  # MAX_ENCODEABLE_XYZ
_SRGB = (2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045)  # the type-4 parametric curve
_GRID = 33


def _inverse(a):
    """cmsmtrx.c _cmsMAT3inverse (cofactors, then division by the
    determinant)."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det, (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det, (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det, (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _product(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)] for i in range(3)]


def _apply(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def _xyz_to_rgb():
    """The output stage's matrix: the inverse of cmsCreate_sRGBProfile's
    colorants (Rec. 709 primaries, white x 0.3127 y 0.3290, adapted to D50
    by Bradford, cmswtpnt.c), times 1 + 32767/32768 (cmsio1.c
    BuildRGBOutputMatrixShaper)."""
    (xr, yr), (xg, yg), (xb, yb), (xw, yw) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06), (0.3127, 0.3290)
    coef = _apply(_inverse([[xr, xg, xb], [yr, yg, yb], [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                  [xw / yw, 1.0, (1.0 - xw - yw) / yw])
    rgb2xyz = [[coef[0] * xr, coef[1] * xg, coef[2] * xb], [coef[0] * yr, coef[1] * yg, coef[2] * yb],
               [coef[0] * (1 - xr - yr), coef[1] * (1 - xg - yg), coef[2] * (1 - xb - yb)]]
    bradford = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367], [0.0389, -0.0685, 1.0296]]
    src = _apply(bradford, [xw / yw, 1.0, (1 - xw - yw) / yw])
    dst = _apply(bradford, list(_D50))
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0], [0.0, 0.0, dst[2] / src[2]]]
    adapt = _product(_inverse(bradford), _product(cone, bradford))
    return [[x * _ADJ for x in row] for row in _inverse(_product(adapt, rgb2xyz))]


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """lcms2_internal.h _cmsQuickSaturateWord: + 0.5, clamped to 0..65535,
    floored through the 2^36 * 1.5 magic number (the value first rounded
    to 1/65536)."""
    d = d + 0.5
    t = (d - 32767.0) + 68719476736.0 * 1.5
    low = (t.view(np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32).astype(np.int64)
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, (low >> 16) + 32767))


@functools.lru_cache(maxsize=1)
def clut() -> np.ndarray:
    """The 33^3 x 3 CLUT (int64, 16-bit values), indexed [L, a, b]."""
    f32 = np.float32
    q = _saturate_word(np.arange(_GRID) * 65535.0 / (_GRID - 1))  # _cmsQuantizeVal
    lab = [(x.astype(f32) / f32(65535.0)).astype(np.float64) for x in np.meshgrid(q, q, q, indexing="ij")]
    fy = (lab[0] * 100.0 + 16.0) / 116.0  # cmsLab2XYZ, D50
    fs = (fy + 0.002 * (lab[1] * 255.0 - 128.0), fy, fy - 0.005 * (lab[2] * 255.0 - 128.0))
    xyz = [(np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t) * w / _ADJ)
           .astype(f32).astype(np.float64) for t, w in zip(fs, _D50)]
    g, a, b, c, d = _SRGB
    out = []
    for row in _xyz_to_rgb():
        lin = (xyz[0] * row[0] + xyz[1] * row[1] + xyz[2] * row[2]).astype(f32).astype(np.float64)
        with np.errstate(invalid="ignore"):
            v = np.where(lin >= (a * d + b) ** g, (np.power(lin, 1.0 / g) - b) / a, lin / c)  # curve type -4
        out.append(_saturate_word(v.astype(f32).astype(np.float64) * 65535.0))
    return np.stack(out, axis=-1)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """``lab [..., 3]`` uint8 as Pillow holds mode ``LAB`` (L 0..255, a and b
    signed bytes, as a TIFF stores them) -> RGB uint8, Pillow's bytes."""
    table = clut()
    v = lab.reshape(-1, 3).astype(np.int64)
    v[:, 1:] ^= 128  # lcms's Lab_8: a and b offset by 128
    v16 = v * 257  # FROM_8_TO_16
    f = v16 * (_GRID - 1)
    f = f + (f + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    i0, r = f >> 16, f & 0xFFFF
    i1 = np.where(v16 == 0xFFFF, i0, i0 + 1)
    order = np.argsort(-r, axis=1, kind="stable")  # the tetrahedron: fractions largest first
    corner = i0.copy()
    prev = table[corner[:, 0], corner[:, 1], corner[:, 2]]
    c0 = prev
    rest = np.full(prev.shape, 0x8001, np.int64)
    rows = np.arange(len(v))
    for k in range(3):
        axis = order[:, k]
        corner[rows, axis] = i1[rows, axis]
        cur = table[corner[:, 0], corner[:, 1], corner[:, 2]]
        rest += (cur - prev) * r[rows, axis][:, None]
        prev = cur
    out16 = (c0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF  # cmsintrp.c TetrahedralInterp16
    return (((out16 * 65281 + 8388608) >> 24) & 0xFF).astype(np.uint8).reshape(lab.shape)  # FROM_16_TO_8
