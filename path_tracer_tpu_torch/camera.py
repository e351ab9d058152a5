"""Pinhole camera: look-at construction, NDC ray generation, interactive moves.

Host copy of ``path_tracer_tpu/camera.py``; `ray_directions` is torch.

Port of ``src/camera.rs``: the camera-to-world transform is the inverse of a
right-handed look-at view matrix (``camera.rs:19``), projection is glam's
``perspective_infinite_rh`` with near=1 (``camera.rs:20``), and rays go through
``(matrix * inv_projection).project_point3(ndc)`` (``camera.rs:94-105``).

Host math is NumPy float32; `ray_directions` is the batched device-side
counterpart used by the wavefront ray-generation stage.

Film orientation: lane v runs bottom-up so that ``t = 2v-1`` is standard NDC;
the PNG writer flips rows (the reference's film row 0 is displayed at the
bottom via its fullscreen-triangle uv convention — ``shader.wgsl:41-52``).
"""

from __future__ import annotations

import numpy as np
import torch


def look_at_matrix(origin, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world ``[3,4]``: columns (right, up, backward | origin) —
    the inverse of glam ``Affine3A::look_at_rh`` (camera.rs:19)."""
    origin = np.asarray(origin, np.float64)
    f = np.asarray(target, np.float64) - origin
    f /= np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.zeros((3, 4), np.float64)
    m[:, 0] = s
    m[:, 1] = u
    m[:, 2] = -f
    m[:, 3] = origin
    return m.astype(np.float32)


def perspective_infinite_rh(fov_y_rad: float, aspect: float, z_near: float = 1.0) -> np.ndarray:
    """glam ``Mat4::perspective_infinite_rh`` as a 4x4 row-major array."""
    f = 1.0 / np.tan(0.5 * fov_y_rad)
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = -1.0
    m[2, 3] = -z_near
    m[3, 2] = -1.0
    return m


class Camera:
    """fov in degrees; aspect = width/height. ``aperture``/``focus_distance``
    are the LIVE form of ``Camera::new``'s dead thin-lens parameters
    (camera.rs:17 — always passed 0.0 there): aperture is the lens diameter
    in world units, focus defaults to the look-at distance."""

    def __init__(self, origin, target, fov: float = 60.0,
                 aspect_ratio: float = 16.0 / 9.0, aperture: float = 0.0,
                 focus_distance: float | None = None):
        self.matrix = look_at_matrix(origin, target)  # [3,4] camera->world
        self.fov = float(fov)
        self.projection = perspective_infinite_rh(np.deg2rad(fov), aspect_ratio)
        self.inv_projection = np.linalg.inv(self.projection)
        self.aperture = float(aperture)
        if focus_distance is None:
            focus_distance = float(np.linalg.norm(
                np.asarray(target, np.float64) - np.asarray(origin, np.float64)))
        self.focus_distance = float(focus_distance)
        # yaw/pitch state for interactive rotation. Naming follows the
        # reference's quirk (camera.rs:23 binds ``(pitch, yaw, _) =
        # to_euler(YXZ)``): ``pitch`` is the rotation about Y, ``yaw`` about
        # X, with R = Ry(pitch) @ Rx(yaw).
        r = self.matrix[:, :3]
        self.pitch = float(np.arctan2(r[0, 2], r[2, 2]))
        self.yaw = float(np.arcsin(np.clip(-r[1, 2], -1.0, 1.0)))

    # -- interactive controls (camera.rs:33-53) --

    def update_origin(self, dx: float, dz: float, dt: float, sensitivity: float = 5.0e5):
        delta = self.matrix[:, :3] @ np.array([dx, 0.0, -dz], np.float32)
        self.matrix[:, 3] += delta * dt * sensitivity

    def update_rotation(self, dx: float, dy: float, dt: float, sensitivity: float = 1.0e4):
        self.yaw -= dy * dt * sensitivity
        self.pitch -= dx * dt * sensitivity
        cy, sy = np.cos(self.pitch), np.sin(self.pitch)
        cx, sx = np.cos(self.yaw), np.sin(self.yaw)
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
        self.matrix[:, :3] = ry @ rx

    def set_aspect(self, aspect_ratio: float) -> None:
        """Rebuild the projection for a new surface aspect (the resize path,
        state.rs surface reconfigure)."""
        self.projection = perspective_infinite_rh(
            np.deg2rad(self.fov), aspect_ratio)
        self.inv_projection = np.linalg.inv(self.projection)

    # -- ray generation --

    def view_proj_inverse(self) -> np.ndarray:
        """4x4 ``matrix * inv_projection`` (NDC -> world), plus its forward
        inverse used by the TAA reprojection (state.rs:95-99)."""
        m4 = np.eye(4, dtype=np.float64)
        m4[:3, :4] = self.matrix
        return (m4 @ self.inv_projection).astype(np.float32)

    def world_to_clip(self) -> np.ndarray:
        m4 = np.eye(4, dtype=np.float64)
        m4[:3, :4] = self.matrix
        return np.linalg.inv(m4 @ self.inv_projection).astype(np.float32)

    @property
    def origin(self) -> np.ndarray:
        return self.matrix[:, 3]


def ray_directions(ndc_to_world: torch.Tensor, origin: torch.Tensor, s: torch.Tensor, t: torch.Tensor):
    """Batched ``Camera::create_ray`` (camera.rs:94-105).

    ``s``/``t`` in [0,1] (t bottom-up); returns unit directions ``[..., 3]``.
    """
    x = s * 2.0 - 1.0
    y = t * 2.0 - 1.0
    m = ndc_to_world
    q = x[..., None] * m[:, 0] + y[..., None] * m[:, 1] + m[:, 3]
    point = q[..., :3] / q[..., 3:4]
    d = point - origin
    n = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
    return d / n[..., None]
