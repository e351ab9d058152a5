"""Profiling: phase timers, ray-rate meters and a device trace (port of
``path_tracer_tpu/utils/profiling.py``).

The reference's only instrumentation is wall-clock prints around BVH/OBJ
builds (``src/tlas.rs:46``, ``blas.rs:129,193``). Here a `PhaseTimer` times
named host phases, a `RayRateMeter` turns the integrator's ray counts into
Mrays/s and spp/s, and `device_trace` records a ``torch.profiler`` trace
(host ops and, on a card, its kernels and copies) as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("path_tracer_tpu_torch")

TRACE_FILE = "trace.json"  # device_trace's file in its directory


class PhaseTimer:
    """Accumulates named phase durations; ``report()`` formats a summary."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            log.info("%s: %.3fs", name, dt)

    def report(self) -> str:
        lines = [f"  {k}: {v:.3f}s" for k, v in self.phases.items()]
        return "phase timings:\n" + "\n".join(lines)


class RayRateMeter:
    """Tracks rays traced / wall time -> Mrays/s and spp/s."""

    def __init__(self):
        self.rays = 0.0
        self.samples = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, rays: float, samples: int = 1):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.rays += rays
            self.samples += samples

    @property
    def mrays_per_s(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds else 0.0

    @property
    def spp_per_s(self) -> float:
        return self.samples / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Record a ``torch.profiler`` trace of the block into
    ``<log_dir>/trace.json`` (Chrome trace format: host ops, and with a
    card its kernels and copies); a no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
