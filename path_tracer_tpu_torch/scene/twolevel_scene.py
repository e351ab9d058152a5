"""Two-level geometry: shared object-space tables + instance transforms.

Port of ``path_tracer_tpu/scene/twolevel_scene.py``. Three engines:

* vwalk and iwalk (`trace.iwalk`, CUDA kernels): each model's chunk tables
  are built once in object space and shared by its instances
  (`trace.iwalk.model_tables`), and the engine tables are packed on the
  host;
* the gather engine (`trace.twolevel`, torch ops): each model's BLAS is
  built once in object space, and a TLAS clusters the instances' world
  boxes (`gather_tables`, the JAX package's ``TwoLevelGeometry`` tables).

The engine rule is the JAX package's (``twolevel_scene.py:119-146`` there):
vwalk unless the scene is over vwalk's cap of virtual chunks, then iwalk
unless it is over iwalk's cap of object chunks, else the gather engine; a
scene above ``IWALK_MAX_OBJECT_TRIS`` takes the gather engine.
``engine="iwalk"`` skips vwalk (the JAX package's ``PT_VWALK=0``) and
``engine="gather"`` skips both (``PT_IWALK=0``).

World boxes map all 8 corners of an object box (the reference maps only its
min/max corners, ``boundingbox.rs:51-57``, wrong under rotation).
"""

from __future__ import annotations

import numpy as np
import torch

from path_tracer_tpu_torch.scene import bvh as bvh_mod
from path_tracer_tpu_torch.scene import triangle as tri_mod
from path_tracer_tpu_torch.scene.model import Model
from path_tracer_tpu_torch.scene.tlas import build_tlas
from path_tracer_tpu_torch.trace import iwalk
from path_tracer_tpu_torch.trace import twolevel as gather
from path_tracer_tpu_torch.trace.bvh_stack import pack_bvh, pack_tris

ENGINES = ("vwalk", "iwalk", "gather")


def gather_tables(models: list[Model]) -> dict:
    """The gather engine's host tables (`trace.twolevel.TABLES`): each
    model's BLAS over its object-space triangles (SAH, leaves of up to 4),
    concatenated with node and triangle offsets applied; the triangles'
    planes and object-space normals in BLAS leaf order; the instance rows;
    the TLAS over the instances' world boxes."""
    blas_nodes, tri_rows, tri_normals = [], [], []
    inst_matrices, inst_roots, inst_models, inst_bmin, inst_bmax = [], [], [], [], []
    node_offset = tri_offset = 0
    for model_id, model in enumerate(models):
        pre = tri_mod.precompute(model.positions)
        bmin, bmax = tri_mod.aabbs(model.positions)
        flat, perm, _ = bvh_mod.build_bvh(bmin, bmax)
        pre = {k: v[perm] for k, v in pre.items()}
        tri_normals.append(model.normals[perm].reshape(-1, 9).astype(np.float32))
        # global offsets: an internal child -> node index, a leaf -> first triangle
        flat = {k: np.array(v) for k, v in flat.items()}
        for c in ("c0", "c1"):
            internal = flat[f"{c}_count"] == 0
            leaf = flat[f"{c}_count"] > 0
            flat[f"{c}_idx"] = np.where(
                internal, flat[f"{c}_idx"] + node_offset,
                np.where(leaf, flat[f"{c}_idx"] + tri_offset, flat[f"{c}_idx"]),
            ).astype(np.int32)
        blas_nodes.append(pack_bvh(flat))
        tri_rows.append(pack_tris(pre))
        for matrix in model.matrices:
            m = np.asarray(matrix, np.float32)
            wmin, wmax = iwalk._aabb_corners_world(flat["root_min"], flat["root_max"], m)
            inst_matrices.append(m)
            inst_roots.append(node_offset)
            inst_models.append(model_id)
            inst_bmin.append(wmin)
            inst_bmax.append(wmax)
        node_offset += flat["c0_idx"].shape[0]
        tri_offset += pre["d0"].shape[0]
    return {
        "tlas_packed": pack_bvh(build_tlas(np.stack(inst_bmin), np.stack(inst_bmax))),
        "blas_packed": np.concatenate(blas_nodes),
        "inst_rows": gather.pack_instances(np.stack(inst_matrices), np.asarray(inst_roots),
                                           np.asarray(inst_models)),
        "tri_packed": np.concatenate(tri_rows),
        "normals_flat": np.concatenate(tri_normals),  # object space [T, 9]
    }


def upload_gather(tables: dict, device) -> dict:
    """The gather engine's tables as tensors on ``device``."""
    return {k: torch.from_numpy(np.array(tables[k], order="C")).to(device) for k in gather.TABLES}


class TwoLevelGeometry:
    """Host-side two-level tables: build once, then ``.device(device)``."""

    def __init__(self, models: list[Model]):
        self.models = models
        self.shared = iwalk.model_tables(models)
        self.num_object_tris = self.shared["num_tris"]
        self.num_instances = len(self.shared["inst_mid"])
        self.num_chunks = int(self.shared["chunk_off"][-1])
        self.num_virtual_chunks = iwalk.num_virtual_chunks(self.shared)
        self.engine = self.choose()
        self._tables = {self.engine: self._pack(self.engine)}

    def choose(self, engine: str | None = None) -> str:
        """The engine for this geometry: ``engine`` if given and it holds the
        scene, else the JAX package's rule (see the module note). Asking for
        vwalk where it cannot hold the scene raises `ValueError`; asking for
        iwalk there gives the gather engine, as ``PT_VWALK=0`` does in the
        JAX package."""
        if engine is not None and engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        if engine == "gather":
            return engine
        small = self.num_object_tris <= iwalk.IWALK_MAX_OBJECT_TRIS
        fits_vwalk = small and self.num_virtual_chunks <= iwalk.VWALK_MAX_VCH
        if engine in (None, "vwalk") and fits_vwalk:
            return "vwalk"
        if engine == "vwalk":
            raise ValueError(
                f"vwalk cannot hold {self.num_object_tris} object tris in "
                f"{self.num_virtual_chunks} virtual chunks (caps {iwalk.IWALK_MAX_OBJECT_TRIS}, "
                f"{iwalk.VWALK_MAX_VCH})")
        return "iwalk" if small and self.num_chunks <= iwalk.IWALK_MAX_TOTAL_CHUNKS else "gather"

    def _pack(self, engine: str) -> dict:
        if engine == "gather":
            return gather_tables(self.models)
        pack = iwalk.pack_vwalk if engine == "vwalk" else iwalk.pack_iwalk
        return pack(self.models, self.shared)

    def tables(self, engine: str | None = None) -> dict:
        """The host (numpy) tables of ``engine`` (default: `choose`'s)."""
        engine = self.choose(engine)
        if engine not in self._tables:
            self._tables[engine] = self._pack(engine)
        return self._tables[engine]

    def device(self, device, engine: str | None = None) -> dict:
        """``{"iwalk": engine tables}`` (vwalk's carry ``vinst``) or
        ``{"gather": the gather engine's tables}`` on ``device``."""
        engine = self.choose(engine)
        if engine == "gather":
            return {"gather": upload_gather(self.tables(engine), device)}
        return {"iwalk": iwalk.upload(self.tables(engine), device)}
