from path_tracer_tpu_torch.interactive.session import InteractiveRenderer  # noqa: F401
from path_tracer_tpu_torch.interactive.taa import (  # noqa: F401
    accumulate,
    compute_velocity,
    display_frame,
    temporal_reproject,
)
