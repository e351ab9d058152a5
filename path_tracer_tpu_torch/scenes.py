"""Standard scenes for tests and benchmarks, mirroring BASELINE.json configs.

Host copy of ``path_tracer_tpu/scenes.py``: the four Cornell-family
scenes, many_instance_scene and env_sphere_scene (dense engine), and
dragon_scene (walk engine), whose knot and sky are memoized on disk
(`utils.disk_cache`). Every constructor takes ``two_level``: with True the
scene keeps shared object-space tables plus instance transforms (the
two-level engines) instead of baking instances to world space; the JAX
CLI rebuilds a baked scene for that, the port builds it so from the start
and skips the baked soup's SAH build.

The reference's scene is hard-coded Rust against OBJ assets that are not in
its repository (``src/main.rs:74-127``); these constructors produce the
equivalent geometry procedurally (and can be saved as OBJ via
``scene.objio.save_obj`` for loader round-trips).

Scene space follows the classic Cornell layout: x in [-278, 278], y in
[0, 555], z in [-278, 278], camera on +z looking down -z.
"""

from __future__ import annotations

import numpy as np

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
from path_tracer_tpu_torch.scene.model import Model, rigid_transform, rotation_y
from path_tracer_tpu_torch.scene.scene import Scene
from path_tracer_tpu_torch.utils.disk_cache import cached_arrays

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


def cornell_diffuse(aspect: float = 1.0, two_level: bool = False) -> tuple[Scene, Camera]:
    """BASELINE config 1: all-diffuse Cornell with the two boxes."""
    models = _cornell_shell()
    tall_p, tall_n = procedural.box((-90.0, 165.0, -65.0), (82.5, 165.0, 82.5))
    short_p, short_n = procedural.box((92.5, 82.5, 85.0), (82.5, 82.5, 82.5))
    models.append(Model(Lambertian(BLUE), positions=tall_p, normals=tall_n))
    models.append(Model(Lambertian(GRAY), positions=short_p, normals=short_n))
    return Scene(models, two_level=two_level), cornell_camera(aspect)


def cornell_specular(aspect: float = 1.0, two_level: bool = False) -> tuple[Scene, Camera]:
    """BASELINE config 2: metal + glass spheres with RR termination."""
    models = _cornell_shell()
    metal_p, metal_n = procedural.icosphere((-120.0, 100.0, -50.0), 100.0, 3)
    glass_p, glass_n = procedural.icosphere((120.0, 100.0, 80.0), 100.0, 3)
    mirror_p, mirror_n = procedural.box((0.0, 450.0, -200.0), (120.0, 60.0, 10.0))
    models.append(Model(GGXMetal((0.1, 0.1, 0.45), 0.4), positions=metal_p, normals=metal_n))
    models.append(Model(Dielectric((0.95, 0.95, 0.95), 1.5), positions=glass_p, normals=glass_n))
    models.append(Model(Specular((1.0, 1.0, 1.0)), positions=mirror_p, normals=mirror_n))
    return Scene(models, two_level=two_level), cornell_camera(aspect)


def cornell_volume(aspect: float = 1.0, two_level: bool = False) -> tuple[Scene, Camera]:
    """Rough-glass (GGX transmissive) sphere with an absorbing/scattering
    medium — the reference's brown-glass dragon material (main.rs:80,87)."""
    models = _cornell_shell()
    vol = Volume(absorption=(0.4, 0.62, 0.7), k=0.1, c=1.0 / 200.0, g=0.6)
    p, n = procedural.icosphere((0.0, 150.0, 0.0), 140.0, 3)
    models.append(Model(GGXDielectric((0.95, 0.95, 0.95), 0.2, 1.5, vol), positions=p, normals=n))
    return Scene(models, two_level=two_level), cornell_camera(aspect)


def mesh_scene(subdivisions: int = 4, aspect: float = 1.0,
               two_level: bool = False) -> tuple[Scene, Camera]:
    """BASELINE config 3: dense triangle mesh through the full BVH."""
    models = _cornell_shell()
    p, n = procedural.icosphere((0.0, 200.0, 0.0), 160.0, subdivisions)
    models.append(Model(GGXMetal((0.8, 0.6, 0.2), 0.3), positions=p, normals=n))
    return Scene(models, two_level=two_level), cornell_camera(aspect)


def many_instance_scene(grid: int = 6, subdivisions: int = 2, aspect: float = 1.0,
                        two_level: bool = False) -> tuple[Scene, Camera]:
    """BASELINE config 5: many instanced meshes (a grid x grid of rotated
    icosphere instances; baked to world unless ``two_level``)."""
    models = _cornell_shell()
    p, n = procedural.icosphere((0.0, 0.0, 0.0), 30.0, subdivisions)
    mats = []
    span = 420.0
    for i in range(grid):
        for j in range(grid):
            x = -span / 2 + span * i / (grid - 1)
            z = -span / 2 + span * j / (grid - 1)
            y = 40.0 + 60.0 * ((i * 7 + j * 3) % 5)
            mats.append(rigid_transform(rotation_y(0.37 * (i + grid * j)), (x, y, z)))
    models.append(Model(Lambertian((0.6, 0.5, 0.4)), matrices=mats, positions=p, normals=n))
    return Scene(models, two_level=two_level), cornell_camera(aspect)


def procedural_sky(h: int = 2048) -> np.ndarray:
    """Synthetic 4K-class equirect HDR: gradient sky + ground + sun disk
    with a soft halo — stands in for the reference's 4K studio env
    (main.rs:75, image_helper.rs:61-88) at the same resolution/cost."""
    w = h * 2
    v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]   # 0 top
    u = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    theta = v * np.pi                  # polar from +y
    phi = u * 2.0 * np.pi
    # sky gradient: zenith blue -> horizon warm white; ground brown
    sy = np.cos(theta) * np.ones_like(phi)   # [h, w]; +1 up, -1 down
    up = np.clip(sy, 0.0, 1.0)
    horizon = np.exp(-np.abs(sy) * 6.0)
    sky = (
        up[..., None] * np.float32([0.22, 0.38, 0.9])
        + horizon[..., None] * np.float32([1.1, 0.95, 0.78])
    )
    ground = np.float32([0.25, 0.2, 0.16]) * (0.4 + 0.6 * np.clip(-sy, 0, 1))[..., None]
    img = np.where((sy > 0)[..., None], sky, ground).astype(np.float32)
    # sun: 2 degree disk at 35 deg elevation + halo
    sun_dir = np.float32([np.cos(0.61) * np.cos(1.1), np.sin(0.61),
                          np.cos(0.61) * np.sin(1.1)])
    d = np.stack([np.sin(theta) * np.cos(phi) * np.ones_like(v),
                  np.cos(theta) * np.ones_like(u),
                  np.sin(theta) * np.sin(phi) * np.ones_like(v)], axis=-1)
    cos_s = np.clip(d @ sun_dir, -1.0, 1.0)
    ang = np.arccos(cos_s)
    img += np.float32([800.0, 700.0, 550.0]) * (ang < 0.018)[..., None]
    img += np.float32([4.0, 3.2, 2.2]) * np.exp(-ang * 14.0)[..., None]
    # the loader linearizes with gamma 2.2 (image_helper.rs:75-80); encode so
    # the round-trip lands on the values above
    return img ** (1.0 / 2.2)


def dragon_scene(nu: int = 768, nv: int = 288, env_h: int = 2048,
                 aspect: float = 1.0, two_level: bool = False) -> tuple[Scene, Camera]:
    """The reference's showcase configuration (main.rs:100-117): Cornell
    shell + TWO instances of a dragon-class mesh (2*nu*nv tris each; 442,368
    at the defaults, 884,748 world tris baked — dragon.obj scale) in brown
    GGX glass with an absorbing/scattering medium (main.rs:80,87), under a
    4K-class equirect env map (main.rs:75). Its world queries go through the
    walk engine (``trace/walk.py``); two-level, through vwalk (10,070
    virtual chunks)."""
    models = _cornell_shell()
    vol = Volume(absorption=(0.4, 0.62, 0.7), k=0.1, c=1.0 / 200.0, g=0.6)
    glass = GGXDielectric((0.95, 0.95, 0.95), 0.2, 1.5, vol)
    # the knot and the sky cost seconds each at this scale and are pure
    # functions of their arguments: memoized on disk, keyed by their source
    p, n = cached_arrays(procedural.knot, scale=42.0, nu=nu, nv=nv)
    mats = [
        rigid_transform(rotation_y(0.7), (-120.0, 160.0, -20.0)),
        rigid_transform(rotation_y(2.3), (130.0, 390.0, 40.0)),
    ]
    models.append(Model(glass, matrices=mats, positions=p, normals=n))
    env = cached_arrays(procedural_sky, env_h)
    return Scene(models, env=env, two_level=two_level), cornell_camera(aspect)


def env_sphere_scene(env_size: int = 64, aspect: float = 1.0,
                     two_level: bool = False) -> tuple[Scene, Camera]:
    """Mirror sphere under a synthetic gradient environment map: exercises
    the equirect miss shader (integrator.rs:256-266). No lights: every path
    ends in the environment."""
    p, n = procedural.icosphere((0.0, 0.0, 0.0), 1.0, 3)
    models = [Model(Specular((1.0, 1.0, 1.0)), positions=p, normals=n)]
    h, w = env_size, env_size * 2
    yy = np.linspace(0, 1, h)[:, None]
    xx = np.linspace(0, 1, w)[None, :]
    env = np.stack(
        [0.2 + 0.8 * xx * np.ones_like(yy), 0.1 + 0.6 * yy * np.ones_like(xx), 0.3 * np.ones((h, w))],
        axis=-1,
    ).astype(np.float32)
    cam = Camera((0.0, 0.0, 4.0), (0.0, 0.0, 0.0), fov=45.0, aspect_ratio=aspect)
    return Scene(models, env=env, two_level=two_level), cam
