"""Configuration: one dataclass tree in place of the reference's compile-time defines.

The port's own copy of the part of ``mega_minecraft_tpu/config.py`` that the port reads
(stdlib only), so that the port imports nothing of the JAX package: the streaming
scheduler's budget (read by ``terrain/scheduler.py``), the path tracer's settings
(read by ``render/tracer.py``) and the engine's frame size, post-processing switches and
slot-table settings (read by ``app/engine.py`` ``EngineConfig.from_config``).  Fields keep
their names, defaults and ``MMTPU_<SECTION>_<FIELD>`` environment overrides; later slices
add the sections they read (the JAX ``DebugConfig`` is left out: no code reads it).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class RenderConfig:
    width: int = 1920  # main.hpp:180
    height: int = 1080
    max_ray_depth: int = 4  # basic_shaders.cu:39
    fog_scatter: float = -0.005  # basic_shaders.cu:41
    use_denoising: bool = True  # defines.hpp:11
    use_upscaling: bool = False  # defines.hpp:12 (render half-res, upscale 2x)
    #: DDA march caps of primary, bounce and shadow rays (a lane gives up after this
    #: many steps and reports a miss)
    max_trace_steps: int = 160
    bounce_trace_steps: int = 32
    shadow_trace_steps: int = 24
    #: exact-reference trace mode: bounce and shadow marches capped at max_trace_steps
    #: and exact (park-and-resolve) alpha cutout on every ray type
    exact_trace: bool = False
    #: perturb hit normals with the normal-map atlas (off: the reference's own
    #: application of that atlas is commented out, basic_shaders.cu:957-958)
    mapped_normals: bool = False


@dataclass
class TerrainConfig:
    chunk_vbos_gen_radius: int = 16  # terrain.cpp:65
    zone_size: int = 12  # terrain.hpp:17
    max_action_time_per_frame: int = 500  # terrain.cpp:71
    total_action_time_per_second: int = 30000  # terrain.cpp:72
    skip_erosion: bool = False  # chunk.cu:12 DEBUG_SKIP_EROSION
    capacity: int = 8192  # chunk slot table size
    stage_batch: int = 16  # at most this many chunks per stage dispatch


@dataclass
class Config:
    render: RenderConfig = field(default_factory=RenderConfig)
    terrain: TerrainConfig = field(default_factory=TerrainConfig)


def load_config(**overrides) -> Config:
    """Config from defaults <- keyword overrides (no environment overrides)
    (dots address nested fields: load_config(**{"terrain.stage_batch": 8}))."""
    cfg = Config()
    for key, val in overrides.items():
        obj = cfg
        *path, leaf = key.split(".")
        for part in path:
            obj = getattr(obj, part)
        setattr(obj, leaf, val)
    return cfg
