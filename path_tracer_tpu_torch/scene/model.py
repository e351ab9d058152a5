"""Model: a mesh + material + instance transforms.

Host copy of ``path_tracer_tpu/scene/model.py``, which mirrors
``Model::new`` (``src/tlas/tlas_bvh/blas/primitive/model.rs:27-52``): one
material per model, a list of rigid instance matrices (scale is rejected,
matching the reference's assert at ``model.rs:43``). The mesh comes from an
OBJ path (parsed by the native builder when it is available, else by
`scene.objio.load_obj`; the same output) or is passed as triangle-soup
arrays (procedural scenes). `rigid_transform` and `rotation_y` build
instance matrices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from path_tracer_tpu_torch.scene.materials import Material
from path_tracer_tpu_torch.scene.objio import load_obj

IDENTITY = np.eye(3, 4, dtype=np.float32)


def rigid_transform(rotation: np.ndarray | None = None, translation=None) -> np.ndarray:
    """Build a ``[3,4]`` rigid transform from a 3x3 rotation and translation."""
    m = np.eye(3, 4, dtype=np.float32)
    if rotation is not None:
        m[:, :3] = np.asarray(rotation, np.float32)
    if translation is not None:
        m[:, 3] = np.asarray(translation, np.float32)
    return m


def rotation_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _check_rigid(matrix: np.ndarray) -> None:
    r = matrix[:, :3]
    if not np.allclose(r @ r.T, np.eye(3), atol=1e-4):
        raise ValueError("Model matrix can only contain translation and rotation")


@dataclass
class Model:
    material: Material
    matrices: list = field(default_factory=lambda: [IDENTITY])
    positions: np.ndarray | None = None  # [T,3,3]
    normals: np.ndarray | None = None  # [T,3,3]
    file_path: str | None = None  # an OBJ file, read when positions is None

    def __post_init__(self):
        for m in self.matrices:
            _check_rigid(np.asarray(m, np.float32))
        if self.positions is None:
            if self.file_path is None:
                raise ValueError("Model needs file_path or triangle arrays")
            from path_tracer_tpu_torch import native

            if native.available():
                self.positions, self.normals = native.load_obj(self.file_path)
            else:
                self.positions, self.normals = load_obj(self.file_path)
        self.positions = np.asarray(self.positions, np.float32)
        if self.normals is None:
            # face-normal fallback for procedurally passed geometry
            fn = np.cross(
                self.positions[:, 1] - self.positions[:, 0],
                self.positions[:, 2] - self.positions[:, 0],
            )
            self.normals = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
        self.normals = np.asarray(self.normals, np.float32)
