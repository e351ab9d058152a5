"""path_tracer_tpu_torch — the PyTorch + CUDA port of ``path_tracer_tpu``.

The JAX package beside it is the reference; this package runs the same
offline render (wavefront NEE+MIS path tracing, Russian roulette, nested
media, Gran Turismo tonemap) on an NVIDIA card, with the two dense
intersection queries as hand-written CUDA kernels
(``csrc/dense_hit.cu``, bound in ``trace/dense_cuda.py``).

Every function takes tensors and an explicit ``device``; nothing here sets a
global default device, and nothing imports JAX.
"""

__version__ = "0.1.0"
