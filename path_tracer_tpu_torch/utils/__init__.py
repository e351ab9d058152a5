from path_tracer_tpu_torch.utils.config import RenderConfig, load_scene_json  # noqa: F401
from path_tracer_tpu_torch.utils.profiling import PhaseTimer, RayRateMeter  # noqa: F401
