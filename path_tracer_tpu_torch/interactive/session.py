"""Interactive progressive-rendering session: the reference's frame loop
(port of ``path_tracer_tpu/interactive/session.py``).

Headless equivalent of ``State``/``run()`` (``src/state.rs:505-586``,
``src/main.rs:141-224``): each `InteractiveRenderer.frame` traces 1 sample
per pixel, then either

* camera static: progressive accumulation (the ``accumulate.wgsl`` path), or
* camera moved: velocity + temporal reprojection (``velocity.wgsl`` +
  ``compute.wgsl``), restarting accumulation from the reprojected history,

and `InteractiveRenderer.display` returns the tonemapped frame
(``shader.wgsl``). WASD and mouse input map to ``Camera.update_origin`` /
``update_rotation`` (``camera.rs:33-92``). There is no OS window: callers
get frames as arrays (save them, stream them with `interactive.stream`, or
wire them to any UI). With a process ``group`` (the JAX package's
``mesh``), every rank's session traces its slab of each frame
(`parallel.mesh.frame_segmented_sharded`) on its own card.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from path_tracer_tpu_torch.camera import Camera
from path_tracer_tpu_torch.integrator import bsdf
from path_tracer_tpu_torch.integrator.wavefront import (
    SegmentPredictor,
    render_sample,
    render_sample_segmented,
)
from path_tracer_tpu_torch.interactive import taa
from path_tracer_tpu_torch.parallel.mesh import frame_segmented_sharded

# Dead-lane segmented compaction (`render_sample_segmented`): the same bits
# as `render_sample`; PT_INTERACTIVE_SEG=0 takes the monolithic frame.
_SEGMENTED = os.environ.get("PT_INTERACTIVE_SEG", "1") != "0"


class InteractiveRenderer:
    def __init__(
        self,
        scene_host,
        camera: Camera,
        width: int,
        height: int,
        max_bounces: int = 64,
        enable_nee: bool = True,
        device="cuda",
        group=None,
    ):
        """``scene_host``: a host `Scene` (uploaded to ``device``) or a
        scene tensor dict already there. ``device`` defaults to the card; a
        CUDA device with no card raises.

        ``group``: a ``torch.distributed`` process group
        (``torch.distributed.group.WORLD`` for the default one); None
        traces every frame in this process. With a group, every rank
        builds its own session on its own ``device`` and calls `frame` in
        lockstep; rank 0 takes the input (`key`, `mouse`, `resize`) and
        sends its camera, film size and sample count to the others at the
        start of each frame (one broadcast); each rank traces its slab of
        the frame, and every rank runs accumulation, TAA and display on
        the gathered film (two film-sized ``all_gather`` calls a frame),
        so `display` works on any rank."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InteractiveRenderer: device 'cuda' but torch.cuda.is_available() "
                               "is False")
        self.scene = (scene_host.device(self.device) if hasattr(scene_host, "device")
                      else scene_host)
        self.has_lights = "light" in self.scene
        # scene specialization: trace only the materials present
        self.mtypes = getattr(scene_host, "active_mtypes", bsdf.ALL_MTYPES)
        self.any_volumes = getattr(scene_host, "has_volumes", True)
        self.camera = camera
        self.width = width
        self.height = height
        self.max_bounces = max_bounces
        self.enable_nee = enable_nee
        self.group = group
        self._reset_history()
        # temporal segment-schedule prediction (PT_SEG_PREDICT)
        self._predictor = SegmentPredictor()

    def _reset_history(self) -> None:
        h, w = self.height, self.width
        self.accumulation = torch.zeros((h, w, 4), dtype=torch.float32, device=self.device)
        self.ids = torch.zeros((h, w), dtype=torch.int64, device=self.device)
        self.sample = 0
        self.last_world_to_clip = np.asarray(self.camera.world_to_clip())
        self._camera_moved = False

    # -- input events (main.rs:147, camera.rs:55-92) --

    def key(self, key: str, dt: float) -> None:
        moves = {"w": (0.0, 1.0), "s": (0.0, -1.0), "a": (-1.0, 0.0), "d": (1.0, 0.0)}
        if key.lower() in moves:
            dx, dz = moves[key.lower()]
            self.camera.update_origin(dx, dz, dt)
            self._camera_moved = True

    def mouse(self, dx: float, dy: float, dt: float) -> None:
        self.camera.update_rotation(dx, dy, dt)
        self._camera_moved = True

    # -- frame loop (main.rs:179-218, state.rs:557-586) --

    def _sync_input(self) -> None:
        """Rank 0's film size, sample count, camera, moved flag and last
        clip transform, sent to every rank at the start of a frame; a rank
        whose size or sample count differs (rank 0 resized) drops its
        history as rank 0 did."""
        c = self.camera
        state = np.concatenate([
            [self.width, self.height, self.sample, float(self._camera_moved), c.pitch, c.yaw],
            c.matrix.ravel(), c.projection.ravel(), c.inv_projection.ravel(),
            self.last_world_to_clip.ravel()])
        buf = torch.as_tensor(state, dtype=torch.float64, device=self.device)
        dist.broadcast(buf, src=dist.get_global_rank(self.group, 0), group=self.group)
        if dist.get_rank(self.group) == 0:
            return
        v = buf.cpu().numpy()
        size_sample = (int(v[0]), int(v[1]), int(v[2]))
        if size_sample != (self.width, self.height, self.sample):
            self.width, self.height = size_sample[:2]
            self._reset_history()
            self.sample = size_sample[2]
        self._camera_moved = bool(v[3])
        c.pitch, c.yaw = float(v[4]), float(v[5])
        c.matrix = v[6:18].reshape(3, 4).astype(np.float32)
        c.projection = v[18:34].reshape(4, 4)
        c.inv_projection = v[34:50].reshape(4, 4)
        self.last_world_to_clip = v[50:66].reshape(4, 4).astype(np.float32)

    def frame(self) -> None:
        if self.group is not None:
            self._sync_input()
        h, w = self.height, self.width
        if self.group is not None:
            entry = partial(frame_segmented_sharded, group=self.group, predictor=self._predictor)
        elif _SEGMENTED:
            entry = partial(render_sample_segmented, predictor=self._predictor)
        else:
            entry = render_sample
        rad, pos, fid, _ = entry(
            self.scene,
            torch.as_tensor(self.camera.view_proj_inverse(), device=self.device),
            torch.as_tensor(self.camera.origin, device=self.device),
            self.sample,
            w,
            h,
            max_bounces=self.max_bounces,
            enable_nee=self.enable_nee,
            has_lights=self.has_lights,
            mtypes=self.mtypes,
            any_volumes=self.any_volumes,
        )
        ones = torch.ones((rad.shape[0], 1), dtype=torch.float32, device=self.device)
        colour = torch.cat([rad, ones], dim=1).reshape(h, w, 4)
        if self._camera_moved:
            self.ids, self.accumulation = taa.frame_update_moving(
                self.ids, self.accumulation, colour, fid.reshape(h, w), pos.reshape(h, w, 4),
                torch.as_tensor(self.last_world_to_clip, device=self.device))
            self._camera_moved = False
        else:
            self.ids, self.accumulation = taa.frame_update_static(
                self.ids, self.accumulation, colour, fid.reshape(h, w))
        self.last_world_to_clip = np.asarray(self.camera.world_to_clip())
        self.sample += 1

    def resize(self, width: int, height: int) -> None:
        """Surface resize (state.rs:74-118 reconfigure): rebuild the
        projection for the new aspect, drop the accumulation and id history
        (stale reprojection sources), restart progressive sampling."""
        if width == self.width and height == self.height:
            return
        self.width, self.height = width, height
        self.camera.set_aspect(width / height)
        self._reset_history()

    def display(self, as_uint8: bool = False) -> np.ndarray:
        """Tonemapped [H,W,3] frame on the host, image-row order (top
        first). ``as_uint8``: quantize on the device before the copy (a
        quarter of the bytes); the default is float32 in [0,1]."""
        return self.display_device(as_uint8).cpu().numpy()[::-1]

    def display_device(self, as_uint8: bool = False) -> torch.Tensor:
        """Tonemapped frame as a device tensor, bottom row first (flip with
        ``[::-1]`` after the copy): a caller can start the copy with
        ``.to("cpu", non_blocking=True)`` and overlap it with the next
        frame's trace (state.rs:505-586)."""
        fn = taa.display_frame_u8 if as_uint8 else taa.display_frame
        return fn(self.accumulation)
