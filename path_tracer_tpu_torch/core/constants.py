"""Global numeric policy constants (copy of ``path_tracer_tpu/core/constants.py``).

Mirrors the reference's epsilon/infinity policy (``src/utility.rs:4-5``) and the
integrator constants (``src/integrator.rs:10-11``, ``src/main.rs:43-51``).
"""

EPSILON = 5e-4
INFINITY = float("inf")

# Integrator defaults (reference: src/integrator.rs:10-11, src/main.rs:49-51)
MIN_PDF = 0.0
HEURISTIC_POWER = 2
MAX_BOUNCES = 1024
ENABLE_NEE = True

# Russian roulette starts after this many bounces (reference: src/integrator.rs:165)
RR_START_BOUNCE = 3
RR_MAX_SURVIVE = 0.9999

# Firefly clamp: radiance vectors are clamped to this max length
# (reference: src/integrator.rs:274)
FIREFLY_CLAMP = 100.0

# Background used when no environment map is loaded (reference: src/integrator.rs:265)
DEFAULT_BACKGROUND = 0.006

# Maximum nested-volume depth tracked per path. The reference uses an unbounded
# pointer set (src/integrator.rs:161); a wavefront SoA integrator needs a fixed
# bound. 4 covers any sane scene of nested transmissive media.
VOLUME_STACK_DEPTH = 4
