"""Film: resolve, the tonemapped image, checkpoint/resume (port of
``path_tracer_tpu/film/film.py``).

The film is a ``[H, W, 4]`` float32 tensor: rgb radiance sums and the sample
count in alpha (the reference's ``accumulate.wgsl`` layout). Checkpoints are
the JAX package's ``.npz`` format, so each package resumes the other's
films. `save_png` writes the format of the extension, as the JAX package's
``Image.save(path)`` does, with the port's codecs (`utils.imageio`: the
card's machine has no Pillow): PNG (``.png``, ``.apng``), JPEG at quality
75, TIFF, GIF, BMP, DIB, PPM, TGA and WebP (lossy, quality 80) by Pillow's
extension table; any other extension raises ``ValueError``.
"""

from __future__ import annotations

import numpy as np
import torch

from path_tracer_tpu_torch.core.tonemap import tonemap_to_srgb
from path_tracer_tpu_torch.utils.imageio import write_image


def resolve(film: torch.Tensor) -> torch.Tensor:
    """Mean radiance: rgb sum / sample count (shader.wgsl fs_main)."""
    return film[..., :3] / torch.clamp(film[..., 3:4], min=1.0)


def film_to_srgb(film: torch.Tensor) -> torch.Tensor:
    """Resolve + GT tonemap + gamma 2.2 encode -> [0,1] rgb."""
    return tonemap_to_srgb(resolve(film))


def save_png(path, film: torch.Tensor) -> None:
    """Write the tonemapped film in the format of the extension (the JAX
    package's name). Film rows run bottom-up (NDC convention, see the
    camera module), so flip for image order."""
    srgb = film_to_srgb(film).cpu().numpy()
    write_image(path, np.clip(srgb * 255.0, 0, 255).astype(np.uint8)[::-1])


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
