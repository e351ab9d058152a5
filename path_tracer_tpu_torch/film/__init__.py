from path_tracer_tpu_torch.film.film import (  # noqa: F401
    film_to_srgb,
    load_checkpoint,
    resolve,
    save_checkpoint,
    save_png,
)
