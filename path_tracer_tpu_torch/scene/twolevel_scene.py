"""Two-level geometry: shared object-space chunk tables + instance transforms.

Port of ``path_tracer_tpu/scene/twolevel_scene.py``'s fast engines: each
model's chunk tables are built once in object space and shared by its
instances (`trace.iwalk.model_tables`), and the engine tables are packed on
the host. The engine rule is the JAX package's (``twolevel_scene.py:119-146``
there): vwalk unless the scene is over vwalk's cap of virtual chunks, then
iwalk unless it is over iwalk's cap of object chunks; ``engine="iwalk"``
asks for iwalk (the JAX package's ``PT_VWALK=0``). Above both caps, or above
``IWALK_MAX_OBJECT_TRIS``, the JAX package falls back to its gather phase
machine (``trace/twolevel.py``), which the port does not have: that raises
`NotImplementedError`.

World boxes map all 8 corners of an object box (the reference maps only its
min/max corners, ``boundingbox.rs:51-57``, wrong under rotation).
"""

from __future__ import annotations

from path_tracer_tpu_torch.scene.model import Model
from path_tracer_tpu_torch.trace import iwalk

ENGINES = ("vwalk", "iwalk")


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
        """The engine for this geometry: ``engine`` if given, else vwalk
        unless it is over its cap, else iwalk. Raises `NotImplementedError`
        when the chosen engine cannot hold the scene."""
        if engine is not None and engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        if self.num_object_tris > iwalk.IWALK_MAX_OBJECT_TRIS:
            raise NotImplementedError(
                f"{self.num_object_tris} object tris exceed the two-level engines' "
                f"{iwalk.IWALK_MAX_OBJECT_TRIS}; the gather phase machine is not ported")
        if engine is None:
            engine = "vwalk" if self.num_virtual_chunks <= iwalk.VWALK_MAX_VCH else "iwalk"
        if engine == "vwalk" and self.num_virtual_chunks > iwalk.VWALK_MAX_VCH:
            raise NotImplementedError(
                f"{self.num_virtual_chunks} virtual chunks exceed vwalk's {iwalk.VWALK_MAX_VCH}")
        if engine == "iwalk" and self.num_chunks > iwalk.IWALK_MAX_TOTAL_CHUNKS:
            raise NotImplementedError(
                f"{self.num_chunks} object chunks exceed iwalk's {iwalk.IWALK_MAX_TOTAL_CHUNKS}; "
                "the gather phase machine is not ported")
        return engine

    def _pack(self, engine: str) -> dict:
        pack = iwalk.pack_vwalk if engine == "vwalk" else iwalk.pack_iwalk
        return pack(self.models, self.shared)

    def tables(self, engine: str | None = None) -> dict:
        """The host (numpy) tables of ``engine`` (default: `choose`'s)."""
        engine = self.choose(engine)
        if engine not in self._tables:
            self._tables[engine] = self._pack(engine)
        return self._tables[engine]

    def device(self, device, engine: str | None = None) -> dict:
        """``{"iwalk": engine tables}`` on ``device`` (the JAX package's key;
        the tables say which engine: vwalk's carry ``vinst``)."""
        return {"iwalk": iwalk.upload(self.tables(engine), device)}
