from path_tracer_tpu_torch.parallel.mesh import (  # noqa: F401
    frame_segmented_sharded,
    gather_lanes,
    make_group,
    render_sample_sharded,
    render_sharded,
    render_spp_sharded,
    shard_lanes,
)
