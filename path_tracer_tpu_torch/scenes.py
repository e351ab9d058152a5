"""Standard scenes for tests and benchmarks, mirroring BASELINE.json configs.

Host copy of the first four scenes of ``path_tracer_tpu/scenes.py``
(many_instance_scene, dragon_scene and env_sphere_scene wait for the port
of their engines).

The reference's scene is hard-coded Rust against OBJ assets that are not in
its repository (``src/main.rs:74-127``); these constructors produce the
equivalent geometry procedurally (and can be saved as OBJ via
``scene.objio.save_obj`` for loader round-trips).

Scene space follows the classic Cornell layout: x in [-278, 278], y in
[0, 555], z in [-278, 278], camera on +z looking down -z.
"""

from __future__ import annotations

from path_tracer_tpu_torch.camera import Camera
from path_tracer_tpu_torch.scene import procedural
from path_tracer_tpu_torch.scene.materials import (
    Dielectric,
    Emissive,
    GGXDielectric,
    GGXMetal,
    Lambertian,
    Specular,
    Volume,
)
from path_tracer_tpu_torch.scene.model import Model
from path_tracer_tpu_torch.scene.scene import Scene

# Reference Cornell palette (main.rs:82-92)
GRAY = (0.73, 0.73, 0.73)
GREEN = (0.12, 0.45, 0.15)
RED = (0.65, 0.05, 0.05)
BLUE = (0.05, 0.05, 0.25)
LIGHT = (15.0, 15.0, 15.0)


def cornell_camera(aspect: float = 1.0) -> Camera:
    return Camera((0.0, 277.5, 1300.0), (0.0, 277.5, 0.0), fov=40.0, aspect_ratio=aspect)


def _cornell_shell() -> list[Model]:
    walls_p, walls_n = procedural.cornell_walls()
    left_p, left_n = procedural.cornell_left()
    right_p, right_n = procedural.cornell_right()
    light_p, light_n = procedural.cornell_light()
    return [
        Model(Emissive(LIGHT), positions=light_p, normals=light_n),
        Model(Lambertian(GRAY), positions=walls_p, normals=walls_n),
        Model(Lambertian(RED), positions=right_p, normals=right_n),
        Model(Lambertian(GREEN), positions=left_p, normals=left_n),
    ]


def cornell_diffuse(aspect: float = 1.0) -> tuple[Scene, Camera]:
    """BASELINE config 1: all-diffuse Cornell with the two boxes."""
    models = _cornell_shell()
    tall_p, tall_n = procedural.box((-90.0, 165.0, -65.0), (82.5, 165.0, 82.5))
    short_p, short_n = procedural.box((92.5, 82.5, 85.0), (82.5, 82.5, 82.5))
    models.append(Model(Lambertian(BLUE), positions=tall_p, normals=tall_n))
    models.append(Model(Lambertian(GRAY), positions=short_p, normals=short_n))
    return Scene(models), cornell_camera(aspect)


def cornell_specular(aspect: float = 1.0) -> tuple[Scene, Camera]:
    """BASELINE config 2: metal + glass spheres with RR termination."""
    models = _cornell_shell()
    metal_p, metal_n = procedural.icosphere((-120.0, 100.0, -50.0), 100.0, 3)
    glass_p, glass_n = procedural.icosphere((120.0, 100.0, 80.0), 100.0, 3)
    mirror_p, mirror_n = procedural.box((0.0, 450.0, -200.0), (120.0, 60.0, 10.0))
    models.append(Model(GGXMetal((0.1, 0.1, 0.45), 0.4), positions=metal_p, normals=metal_n))
    models.append(Model(Dielectric((0.95, 0.95, 0.95), 1.5), positions=glass_p, normals=glass_n))
    models.append(Model(Specular((1.0, 1.0, 1.0)), positions=mirror_p, normals=mirror_n))
    return Scene(models), cornell_camera(aspect)


def cornell_volume(aspect: float = 1.0) -> tuple[Scene, Camera]:
    """Rough-glass (GGX transmissive) sphere with an absorbing/scattering
    medium — the reference's brown-glass dragon material (main.rs:80,87)."""
    models = _cornell_shell()
    vol = Volume(absorption=(0.4, 0.62, 0.7), k=0.1, c=1.0 / 200.0, g=0.6)
    p, n = procedural.icosphere((0.0, 150.0, 0.0), 140.0, 3)
    models.append(Model(GGXDielectric((0.95, 0.95, 0.95), 0.2, 1.5, vol), positions=p, normals=n))
    return Scene(models), cornell_camera(aspect)


def mesh_scene(subdivisions: int = 4, aspect: float = 1.0) -> tuple[Scene, Camera]:
    """BASELINE config 3: dense triangle mesh through the full BVH."""
    models = _cornell_shell()
    p, n = procedural.icosphere((0.0, 200.0, 0.0), 160.0, subdivisions)
    models.append(Model(GGXMetal((0.8, 0.6, 0.2), 0.3), positions=p, normals=n))
    return Scene(models), cornell_camera(aspect)
