"""Run configuration and JSON scene descriptions (port of
``path_tracer_tpu/utils/config.py``).

The reference has no config layer: film size, spp, bounce limit and the scene
itself are compile-time constants and hard-coded Rust (``src/main.rs:43-51,
74-127``). Here the same knobs are a dataclass, the CLI and a JSON scene
schema, with the reference's values as defaults.

JSON scene schema::

    {
      "env": "path/to/env.png",            // optional equirect map (any format envmap.load_image reads)
      "camera": {"origin": [x,y,z], "look_at": [x,y,z], "fov": deg,
                 "aperture": d, "focus": dist},   // optional
      "two_level": false,                   // optional
      "models": [
        {
          "obj": "mesh.obj",                // OR "primitive": {...}
          "primitive": {"type": "icosphere"|"box"|"cornell_walls"|..., ...},
          "material": {"type": "lambertian", "albedo": [r,g,b]},
          "instances": [ {"rotation_y": rad, "translation": [x,y,z]}, ... ]
        }
      ]
    }

Material types mirror the constructors in `scene.materials`: ``lambertian``
(albedo), ``emissive`` (emitted), ``specular`` (colour), ``ggx_metal``
(colour, roughness), ``ggx_dielectric`` (colour, roughness, ior, volume?),
``dielectric`` (colour, ior, volume?); ``volume`` = {absorption, k, c, g}
(volume.rs:136-142 semantics). Paths inside the file (``env``, ``obj``)
resolve against the working directory, as in the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from path_tracer_tpu_torch.core import constants


@dataclass
class RenderConfig:
    """Defaults match the reference's compile-time constants
    (main.rs:43-51)."""

    width: int = 1024
    height: int = 576  # 16:9 of 1024 (main.rs:43-45)
    spp: int = 256  # SAMPLES_PER_PIXEL (main.rs:47)
    max_bounces: int = constants.MAX_BOUNCES
    enable_nee: bool = constants.ENABLE_NEE
    fov: float = 60.0  # main.rs:127
    seed_sample_offset: int = 0
    output: str = "render.png"
    checkpoint: str | None = None
    checkpoint_every: int = 0  # samples between checkpoints; 0 = off
    multichip: bool = False

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height


def _material_from_json(m: dict):
    from path_tracer_tpu_torch.scene import materials as M

    vol = None
    if "volume" in m:
        v = m["volume"]
        vol = M.Volume(
            absorption=tuple(v.get("absorption", (0, 0, 0))),
            k=float(v.get("k", 0.0)),
            c=float(v.get("c", 0.0)),
            g=float(v.get("g", 0.0)),
        )
    t = m["type"]
    if t == "lambertian":
        return M.Lambertian(m["albedo"])
    if t == "emissive":
        return M.Emissive(m["emitted"])
    if t == "specular":
        return M.Specular(m.get("colour", (1.0, 1.0, 1.0)))
    if t == "ggx_metal":
        return M.GGXMetal(m["colour"], float(m["roughness"]))
    if t == "ggx_dielectric":
        return M.GGXDielectric(m["colour"], float(m["roughness"]), float(m.get("ior", 1.5)), vol)
    if t == "dielectric":
        return M.Dielectric(m.get("colour", (1.0, 1.0, 1.0)), float(m.get("ior", 1.5)), vol)
    raise ValueError(f"unknown material type {t!r}")


def _primitive_from_json(p: dict):
    from path_tracer_tpu_torch.scene import procedural

    t = p["type"]
    if t == "icosphere":
        return procedural.icosphere(
            tuple(p.get("center", (0, 0, 0))), float(p.get("radius", 1.0)),
            int(p.get("subdivisions", 3)),
        )
    if t == "box":
        return procedural.box(tuple(p["center"]), tuple(p["half_extents"]))
    if t in ("cornell_walls", "cornell_left", "cornell_right", "cornell_light"):
        return getattr(procedural, t)()
    raise ValueError(f"unknown primitive type {t!r}")


def _instance_from_json(inst: dict):
    from path_tracer_tpu_torch.scene.model import rigid_transform, rotation_y

    rot = None
    if "rotation_y" in inst:
        rot = rotation_y(float(inst["rotation_y"]))
    return rigid_transform(rot, inst.get("translation"))


def load_scene_json(path, two_level: bool = False):
    """Load a JSON scene description -> ``Scene``; ``two_level`` (or the
    file's ``"two_level"``) keeps instances in object space."""
    from path_tracer_tpu_torch.scene.envmap import load_image
    from path_tracer_tpu_torch.scene.model import IDENTITY, Model
    from path_tracer_tpu_torch.scene.scene import Scene

    with open(path) as f:
        desc = json.load(f)

    models = []
    for md in desc["models"]:
        material = _material_from_json(md["material"])
        matrices = [_instance_from_json(i) for i in md.get("instances", [])] or [IDENTITY]
        if "obj" in md:
            models.append(Model(material, matrices=matrices, file_path=md["obj"]))
        else:
            pos, nrm = _primitive_from_json(md["primitive"])
            models.append(Model(material, matrices=matrices, positions=pos, normals=nrm))

    env = load_image(desc["env"]) if desc.get("env") else None
    return Scene(models, env=env, two_level=two_level or desc.get("two_level", False))


def load_camera_json(path, aspect: float):
    """Optional ``camera`` block of a JSON scene -> ``Camera`` (or ``None``).

    Schema: ``{"origin": [x,y,z], "look_at": [x,y,z], "fov": deg,
    "aperture": d, "focus": dist}``, mirroring ``Camera::new``
    (camera.rs:17-31); aspect always comes from the film (--width/--height).
    """
    from path_tracer_tpu_torch.camera import Camera

    with open(path) as f:
        c = json.load(f).get("camera")
    if not c:
        return None
    return Camera(
        tuple(c.get("origin", (0.0, 277.5, 1300.0))),
        tuple(c.get("look_at", (0.0, 277.5, 0.0))),
        fov=float(c.get("fov", 60.0)),
        aspect_ratio=aspect,
        aperture=float(c.get("aperture", 0.0)),
        focus_distance=float(c["focus"]) if "focus" in c else None,
    )
