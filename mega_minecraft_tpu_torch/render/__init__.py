"""The render path: brickmap scene build (K10), camera, sky and the 1-spp path tracer
(K11t trace, K11 render_sample, K12 accumulate).  Port of ``mega_minecraft_tpu/render``
(brickmap, camera, sky, materials, tracer)."""
