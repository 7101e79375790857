"""The render path: brickmap scene build (K10), camera, sky and the 1-spp path tracer
(K11t trace, K11 render_sample, K12 accumulate), the engine's frame kernels (K10u, K13,
K14-K16), the debug renderer (K17 ``render_debug``) and the mesher (host code).  Port of
``mega_minecraft_tpu/render``."""

from .debug_renderer import render_debug  # noqa: F401
