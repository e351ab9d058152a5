"""Film: resolve, tonemapped PNG, checkpoint/resume (port of
``path_tracer_tpu/film/film.py``).

The film is a ``[H, W, 4]`` float32 tensor: rgb radiance sums and the sample
count in alpha (the reference's ``accumulate.wgsl`` layout). Checkpoints are
the JAX package's ``.npz`` format, so each package resumes the other's
films. PNGs are written with the standard library (``zlib`` + ``struct``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from path_tracer_tpu_torch.core.tonemap import tonemap_to_srgb


def resolve(film: torch.Tensor) -> torch.Tensor:
    """Mean radiance: rgb sum / sample count (shader.wgsl fs_main)."""
    return film[..., :3] / torch.clamp(film[..., 3:4], min=1.0)


def film_to_srgb(film: torch.Tensor) -> torch.Tensor:
    """Resolve + GT tonemap + gamma 2.2 encode -> [0,1] rgb."""
    return tonemap_to_srgb(resolve(film))


def _png_bytes(rgb8: np.ndarray) -> bytes:
    """8-bit RGB ``[H, W, 3]`` -> PNG file bytes (filter 0 on every row)."""
    h, w, _ = rgb8.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def save_png(path, film: torch.Tensor) -> None:
    """Write the tonemapped film as PNG. Film rows run bottom-up (NDC
    convention, see the camera module), so flip for image order."""
    srgb = film_to_srgb(film).cpu().numpy()
    data = np.clip(srgb * 255.0, 0, 255).astype(np.uint8)[::-1]
    with open(path, "wb") as f:
        f.write(_png_bytes(np.ascontiguousarray(data)))


def save_checkpoint(path, film: torch.Tensor, next_sample: int, meta: dict | None = None) -> None:
    """Persist accumulator + progress so a long render can resume."""
    np.savez_compressed(
        path,
        film=film.detach().cpu().numpy(),
        next_sample=np.int64(next_sample),
        **({f"meta_{k}": v for k, v in (meta or {}).items()}),
    )


def load_checkpoint(path, device):
    """Returns ``(film [H,W,4] on device, next_sample int)``."""
    z = np.load(path)
    return torch.as_tensor(z["film"], dtype=torch.float32).to(device), int(z["next_sample"])
