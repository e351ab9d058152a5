"""Scene assembly: models -> world triangle soup -> device tensor dict.

Port of ``path_tracer_tpu/scene/scene.py``. The host build is the JAX
package's, carried over: instances are baked to world space, the soup is
reordered by the SAH builder's permutation (``bvh.build_sah_tree``), the
emissive triangles form a light table with a power-weighted CDF
(``src/scene.rs:21-35``, ``src/scene/light_sampler.rs``), and a scene with no
environment image gets a 1x1 constant-0.006 one.

`Scene.device` and `from_jax_scene` build the same tensor dict, one from the
host scene and one from the JAX package's own device dict, so both packages
can be fed identical tables:

* ``tri``: ``normals_flat [T, 9]``, ``model_rows [T, 1]`` and one of
  ``dense`` (the dense engine's ``aux`` rows and ``cab`` chunk boxes,
  `trace.dense_cuda`), ``walk``
  (the walk engine's tables, `trace.walk.pack_walk`) or ``stream`` (the
  streamed dense engine's ``aux``/``cab``/``pab``/``qab``,
  `trace.dense_stream.pack_dense_stream`)
  or ``bvh`` (the stack BVH's ``nodes``/``tris``, `trace.bvh_stack.pack`);
* ``light`` (scenes with emitters): ``cdf``, ``rows`` (pdf, area, emitted rgb,
  pad), ``normals_flat``, ``positions_flat`` and ``dense`` (or ``bvh`` above
  ``DENSE_MAX_TRIS`` light triangles);
* ``mat``: ``rows`` (`materials.pack_material_rows`);
* ``env``: ``[H, W, 3]``;
* ``twolevel`` (scenes built with ``two_level=True``): ``{"iwalk": the
  vwalk or iwalk engine's tables}`` or ``{"gather": the gather engine's}``
  (`scene.twolevel_scene`); ``tri`` is then empty.

Engine selection (`world_engine`, the JAX package's TPU build,
``path_tracer_tpu/scene/scene.py:269-331``): every table up to
``DENSE_MAX_TRIS`` triangles, world or lights, goes through the dense
kernels (this also covers the <=256-tri tables the TPU build sends to the
flat stream of ``trace/sweep.py``, which runs the same naive-precision test
with the same tie rule). A larger world soup goes through the walk kernels
up to ``WALK_PARTS_MAX_TRIS``, then through the streamed dense kernels up to
``DENSE_STREAM_MAX_TRIS``; above that through the stack BVH
(`trace.bvh_stack`, torch ops), which is where the JAX package's soup with
no engine key goes (``path_tracer_tpu/scene/scene.py:294-335``).
``engine="stream"`` sends a baked soup up to that size to the streamed
engine, the counterpart of the JAX package's ``PT_WALK=0`` (`env_engine`
reads that variable for the CLI). Chunk and part boxes come from the host
scene's ``positions`` (the lights' dense chunk boxes from their
``positions_flat``). The lights take the dense kernels up to
``DENSE_MAX_TRIS`` triangles and the stack BVH above, over the lights' own
SAH tree, as the JAX package's lights BVH (``scene.py:110-115``): the light
table is in that tree's leaf order either way, so light order, pdf and cdf
are the JAX package's. The stack BVH checks its tree's depth against the
traversal stack, as the JAX scene does (``scene.py:96-97``).

Two-level mode keeps each model's tables in object space, shared by its
instances, and traces the world through the vwalk or iwalk kernels or the
gather engine (`scene.twolevel_scene`). The JAX package builds the baked
world soup and its SAH tree in that mode too and then drops them
(``path_tracer_tpu/scene/scene.py:337-343``); the port does not build them.
The light tables stay world-space and dense.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from path_tracer_tpu_torch.core.constants import DEFAULT_BACKGROUND
from path_tracer_tpu_torch.scene import triangle as tri_mod
from path_tracer_tpu_torch.scene.bvh import build_sah_tree, flatten, tree_depth
from path_tracer_tpu_torch.scene.materials import pack_material_rows, pack_materials
from path_tracer_tpu_torch.scene.model import Model
from path_tracer_tpu_torch.scene.twolevel_scene import TwoLevelGeometry, upload_gather
from path_tracer_tpu_torch.trace import bvh_stack, dense_stream, iwalk
from path_tracer_tpu_torch.trace import twolevel as gather
from path_tracer_tpu_torch.trace.dense_cuda import DENSE_MAX_TRIS, pack_dense_aux, pack_dense_cab
from path_tracer_tpu_torch.trace.walk import WALK_PARTS_MAX_TRIS, pack_walk

SceneData = dict  # nested dict of tensors handed to the integrator


def world_engine(n_tris: int, engine: str | None = None) -> str:
    """The engine of a baked world soup of ``n_tris`` triangles: "dense",
    "walk", "stream" or "bvh" by size, or "stream" where ``engine`` asks for
    it and the soup fits the streamed engine."""
    if engine not in (None, "stream"):
        raise ValueError(f"engine {engine!r}: a baked scene takes None or 'stream'")
    if n_tris > dense_stream.DENSE_STREAM_MAX_TRIS:
        return "bvh"
    if engine is None and n_tris <= DENSE_MAX_TRIS:
        return "dense"
    if engine is None and n_tris <= WALK_PARTS_MAX_TRIS:
        return "walk"
    return "stream"


def env_engine(num_world_tris: int, two_level: bool = False) -> str | None:
    """The engine the JAX package's switches pick: ``PT_WALK=0`` sends a
    baked soup above ``DENSE_MAX_TRIS`` triangles to "stream"; ``PT_IWALK=0``
    sends a two-level scene to "gather", else ``PT_VWALK=0`` to "iwalk"
    (``path_tracer_tpu/scene/twolevel_scene.py:123-141``); else None (the
    default rule). Neither kind of switch touches the other kind of scene."""
    if two_level:
        if os.environ.get("PT_IWALK", "1") == "0":
            return "gather"
        return "iwalk" if os.environ.get("PT_VWALK", "1") == "0" else None
    off = os.environ.get("PT_WALK", "1") == "0"
    return "stream" if off and num_world_tris > DENSE_MAX_TRIS else None


def _sah_tree(positions: np.ndarray):
    """The SAH tree over the triangles: ``(nodes, perm, root)``."""
    bmin, bmax = tri_mod.aabbs(positions)
    return build_sah_tree(bmin, bmax, max_leaf=bvh_stack.MAX_LEAF)


def _stack_tables(tree, tab: dict) -> dict:
    """The stack BVH's tables for the SAH tree ``(nodes, perm, root)`` of
    the (already permuted) triangle table ``tab``."""
    nodes, _, root = tree
    return bvh_stack.pack(flatten(nodes, root), tree_depth(nodes, root), tab)


def _pack_tris(positions: np.ndarray, normals: np.ndarray) -> dict[str, np.ndarray]:
    pre = tri_mod.precompute(positions)
    pre["normals"] = normals.astype(np.float32)
    pre["positions"] = positions.astype(np.float32)
    return pre


class Scene:
    """Host-side scene: build once, then ``.device(device)`` for the renderer."""

    def __init__(self, models: list[Model], env: np.ndarray | None = None,
                 two_level: bool = False):
        """``two_level=True`` keeps each model's tables in object space,
        shared by its instances, instead of baking instances to world (see
        the module note)."""
        self.models = models
        self.two_level = two_level

        world_pos, world_nrm, world_model = [], [], []
        light_pos, light_nrm, light_mat = [], [], []

        mat_table = pack_materials([m.material for m in models])

        for model_id, model in enumerate(models):
            emissive = bool(mat_table["is_emissive"][model_id])
            for matrix in model.matrices:
                if two_level and not emissive:
                    continue  # only the lights are baked
                p, n = tri_mod.transform(model.positions, model.normals, np.asarray(matrix, np.float32))
                world_pos.append(p)
                world_nrm.append(n)
                world_model.append(np.full(p.shape[0], model_id, np.int32))
                if emissive:
                    light_pos.append(p)
                    light_nrm.append(n)
                    light_mat.append(np.full(p.shape[0], model_id, np.int32))

        if two_level:
            self.twolevel = TwoLevelGeometry(models)
            self.tri = self.world_bvh = None
            self.num_world_tris = sum(m.positions.shape[0] * len(m.matrices) for m in models)
        else:
            world_pos = np.concatenate(world_pos)
            tree = _sah_tree(world_pos)
            self.perm = perm = tree[1]
            world_model = np.concatenate(world_model)[perm]
            self.tri = _pack_tris(world_pos[perm], np.concatenate(world_nrm)[perm])
            # one material per model: material id == model id
            self.tri["mat"] = world_model
            self.tri["model"] = world_model
            self.num_world_tris = world_pos.shape[0]
            # the tree itself only where the stack BVH traverses it
            self.world_bvh = (_stack_tables(tree, self.tri)
                              if world_engine(self.num_world_tris) == "bvh" else None)

        # Lights: emissive triangles only (scene.rs:23-28) with a
        # power-weighted CDF (light weight = area * |emitted|, blas.rs:203-212).
        self.has_lights = len(light_pos) > 0
        if self.has_lights:
            lp = np.concatenate(light_pos)
            ltree = _sah_tree(lp)
            lperm = ltree[1]
            lm = np.concatenate(light_mat)[lperm]
            self.light = _pack_tris(lp[lperm], np.concatenate(light_nrm)[lperm])
            self.lights_bvh = (_stack_tables(ltree, self.light)
                               if lp.shape[0] > DENSE_MAX_TRIS else None)
            self.light["mat"] = lm
            emitted = mat_table["emitted"][lm]
            weight = self.light["area"] * np.linalg.norm(emitted, axis=-1)
            pdf = (weight / weight.sum()).astype(np.float32)
            self.light["emitted"] = emitted.astype(np.float32)
            self.light["pdf"] = pdf
            self.light["cdf"] = np.cumsum(pdf).astype(np.float32)
        else:
            self.light = self.lights_bvh = None

        self.mat = mat_table
        # which material models exist and whether any medium is attached:
        # the integrator leaves the others out
        self.active_mtypes = tuple(sorted(set(int(t) for t in mat_table["mtype"])))
        self.has_volumes = bool(mat_table["has_volume"].any())

        if env is None:
            env = np.full((1, 1, 3), DEFAULT_BACKGROUND, np.float32)
        self.env = np.asarray(env, np.float32)

    def device(self, device, engine: str | None = None) -> SceneData:
        """The integrator's tensor dict on ``device`` (see the module note).
        ``engine`` names the world engine: "stream" for a baked scene
        (default: `world_engine`'s rule), "vwalk" or "iwalk" for a
        two-level one, or "gather" (default: `TwoLevelGeometry.choose`'s)."""
        tri = {}
        if not self.two_level:
            tri = {
                "n0": self.tri["n0"], "d0": self.tri["d0"], "n1": self.tri["n1"],
                "d1": self.tri["d1"], "n2": self.tri["n2"], "d2": self.tri["d2"],
                "normals_flat": self.tri["normals"].reshape(-1, 9),
                "model_rows": self.tri["model"].astype(np.float32)[:, None],
                "positions": self.tri["positions"],
            }
            if self.world_bvh is not None:
                tri["bvh"] = self.world_bvh
        data = {"tri": tri, "mat": {"rows": pack_material_rows(self.mat)}, "env": self.env}
        if self.has_lights:
            lt = self.light["pdf"].shape[0]
            lrows = np.zeros((lt, 8), np.float32)
            lrows[:, 0] = self.light["pdf"]
            lrows[:, 1] = self.light["area"]
            lrows[:, 2:5] = self.light["emitted"]
            data["light"] = {
                "n0": self.light["n0"], "d0": self.light["d0"], "n1": self.light["n1"],
                "d1": self.light["d1"], "n2": self.light["n2"], "d2": self.light["d2"],
                "normals_flat": self.light["normals"].reshape(lt, 9),
                "positions_flat": self.light["positions"].reshape(lt, 9),
                "cdf": self.light["cdf"],
                "rows": lrows,
            }
            if self.lights_bvh is not None:
                data["light"]["bvh"] = self.lights_bvh
        out = _upload(data, device, engine)
        if self.two_level:
            out["twolevel"] = self.twolevel.device(device, engine)
        return out


def _dense_table(tab: dict, positions, with_shading: bool) -> dict:
    """Dense engine tables for one triangle table (world or lights; a larger
    one takes the stack BVH): its rows and its chunk boxes, from
    ``positions`` ``[T, 3, 3]`` in table order."""
    t = tab["n0"].shape[0]
    if t > DENSE_MAX_TRIS:
        raise NotImplementedError(
            f"{t} light triangles exceed the dense engine's {DENSE_MAX_TRIS}"
        )
    aux = pack_dense_aux(
        tab,
        tab["normals_flat"] if with_shading else None,
        tab["model_rows"][:, 0] if with_shading else None,
    )
    return {"aux": aux, "cab": pack_dense_cab(positions)}


_PLANE_KEYS = ("n0", "d0", "n1", "d1", "n2", "d2")


def _upload(data: dict, device, engine: str | None = None) -> SceneData:
    """Add the world engine's tables (`world_engine`; ``stream`` and ``bvh``
    tables already in ``tri`` are kept, and the ``bvh`` engine needs them)
    and the lights' (dense, unless ``bvh`` tables are there), drop the
    host-only plane and position arrays, move to ``device``."""
    tri = data["tri"]
    if tri:  # empty in two-level mode
        kind = world_engine(tri["n0"].shape[0], engine)
        shading = (tri, tri["normals_flat"], tri["model_rows"][:, 0], tri["positions"])
        if kind == "walk":
            tri["walk"] = pack_walk(*shading)
        elif kind == "stream":
            if "stream" not in tri:
                tables = dense_stream.pack_dense_stream(*shading)
                tri["stream"] = {k: tables[k] for k in dense_stream.TABLES}
        elif kind == "bvh":
            if "bvh" not in tri:
                raise ValueError("a world soup above the streamed engine's limit needs its "
                                 "stack BVH tables (Scene.device builds them)")
        else:
            tri["dense"] = _dense_table(tri, tri["positions"], with_shading=True)
        tri.pop("positions")
    if "light" in data and "bvh" not in data["light"]:
        light = data["light"]
        light["dense"] = _dense_table(light, np.reshape(light["positions_flat"], (-1, 3, 3)),
                                      with_shading=False)
    for tab in (tri, data.get("light")):
        for k in _PLANE_KEYS:
            if tab:
                tab.pop(k)

    def up(x):
        if isinstance(x, dict):
            return {k: up(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, order="C")).to(device)

    return up(data)


def from_jax_scene(data: dict, device) -> SceneData:
    """The port's tensor dict from the JAX package's ``Scene.device()``
    dict, converted with ``np.asarray`` (nested dicts of arrays). Only
    arrays the two packages share are read; the JAX engine tables (streams,
    ``dense``, ``dense_pl``, ``walk``) are ignored and the port's dense or
    walk tables rebuilt (the walk's from ``tri["positions"]``), except a
    ``dense_stream`` engine, whose ``aux``/``cab``/``pab`` are carried over
    as they are (its group boxes ``qab`` rebuilt from ``tri["positions"]``)
    and traced by the port's streamed engine, and the stack BVH
    row tables (``bvh``/``lights_bvh`` ``packed`` and the triangle tables'
    ``packed``) of a table the port traces through its stack BVH. A two-level
    dict (empty ``tri``) must hold a single-part vwalk or iwalk engine in
    ``twolevel["iwalk"]``, whose kept tables are carried over as they are
    (iwalk's object boxes rebuilt from them by ``iwalk.upload``); a dict
    without one carries the JAX gather machine's tables over, traced by the
    port's gather engine; a multi-part engine raises."""
    a = lambda x: np.asarray(x)  # noqa: E731
    jt = data["tri"]
    tri = {}
    if jt:
        tri = {k: a(jt[k]) for k in _PLANE_KEYS}
        for k in ("normals_flat", "model_rows", "positions"):
            tri[k] = a(jt[k])
        if "dense_stream" in jt:
            stream = {k: a(jt["dense_stream"][k]) for k in dense_stream.JAX_TABLES}
            stream["qab"] = dense_stream.pack_qab(tri["positions"], stream["aux"].shape[0])
            tri["stream"] = stream
        if world_engine(tri["n0"].shape[0]) == "bvh":
            tri["bvh"] = {"nodes": a(data["bvh"]["packed"]), "tris": a(jt["packed"])}
    out = {"tri": tri, "mat": {"rows": a(data["mat"]["rows"])}, "env": a(data["env"])}
    if "light" in data:
        jl = data["light"]
        out["light"] = {k: a(jl[k]) for k in _PLANE_KEYS}
        for k in ("normals_flat", "positions_flat", "cdf", "rows"):
            out["light"][k] = a(jl[k])
        if jl["n0"].shape[0] > DENSE_MAX_TRIS:
            out["light"]["bvh"] = {"nodes": a(data["lights_bvh"]["packed"]), "tris": a(jl["packed"])}
    ported = _upload(out, device, "stream" if "stream" in tri else None)
    if "twolevel" in data:
        tl = data["twolevel"]
        eng = tl.get("iwalk")
        if eng is None:  # the JAX gather phase machine's tables
            ported["twolevel"] = {"gather": upload_gather({k: a(tl[k]) for k in gather.TABLES},
                                                          device)}
        elif "parts" in eng:
            raise NotImplementedError("the port runs single-part vwalk / iwalk engines only")
        else:
            keep = iwalk.VWALK_TABLES if "vinst" in eng else iwalk.IWALK_TABLES
            ported["twolevel"] = {"iwalk": iwalk.upload({k: a(eng[k]) for k in keep}, device)}
    return ported
