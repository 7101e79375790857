"""The port's config tree (``mega_minecraft_tpu_torch/config.py``) vs the JAX package's.

Environment overrides must parse as the JAX original parses them: booleans from the
words "1", "true", "yes", "on" (any case), ints and floats by their constructors.  The
render section holds the fields of the JAX section that the tracer and the engine read,
with their names and defaults (not ``dda_unroll``, a TPU loop-overhead knob); the terrain
section the scheduler's budget and the engine's slot-table settings.  Tolerance: none,
the values are equal.
"""

from __future__ import annotations

import dataclasses

import pytest

from mega_minecraft_tpu import config as jax_config
from mega_minecraft_tpu_torch import config

ENV = {"MMTPU_RENDER_EXACT_TRACE": "0", "MMTPU_RENDER_MAX_TRACE_STEPS": "96",
       "MMTPU_RENDER_FOG_SCATTER": "-0.0125", "MMTPU_RENDER_MAPPED_NORMALS": "On",
       "MMTPU_TERRAIN_STAGE_BATCH": "8", "MMTPU_RENDER_WIDTH": "960", "MMTPU_RENDER_HEIGHT": "540",
       "MMTPU_RENDER_USE_DENOISING": "no", "MMTPU_RENDER_USE_UPSCALING": "1",
       "MMTPU_TERRAIN_CAPACITY": "2048", "MMTPU_TERRAIN_SKIP_EROSION": "true"}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("env", [{}, ENV], ids=["defaults", "overrides"])
def test_load_config_equals_jax_field_by_field(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = config.load_config(), jax_config.load_config()
    ref = _fields(want.render)
    assert _fields(got.render) == {k: ref[k] for k in _fields(got.render)}
    assert set(_fields(got.render)) == {"width", "height", "max_ray_depth", "fog_scatter",
                                        "max_trace_steps", "bounce_trace_steps",
                                        "shadow_trace_steps", "exact_trace", "mapped_normals",
                                        "use_denoising", "use_upscaling"}
    assert {"capacity", "skip_erosion", "stage_batch"} <= set(_fields(got.terrain))
    for name, value in _fields(got.terrain).items():
        assert value == getattr(want.terrain, name), name
    for name, value in _fields(got.render).items():
        assert type(value) is type(ref[name]), name


def test_overrides_parse_by_type(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    r = config.load_config().render
    assert r.exact_trace is False and r.mapped_normals is True
    assert r.max_trace_steps == 96 and r.fog_scatter == -0.0125
    assert config.load_config().terrain.stage_batch == 8
    assert config.load_config(**{"render.max_ray_depth": 2}).render.max_ray_depth == 2
    assert (r.width, r.height, r.use_denoising, r.use_upscaling) == (960, 540, False, True)
    t = config.load_config().terrain
    assert t.capacity == 2048 and t.skip_erosion is True


def test_engine_config_from_config(monkeypatch):
    """EngineConfig.from_config reads the fields JAX's reads, from the environment too."""
    from mega_minecraft_tpu.app.engine import EngineConfig as JaxEngineConfig
    from mega_minecraft_tpu_torch.app.engine import EngineConfig

    for env in ({}, ENV):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got, want = EngineConfig.from_config(), JaxEngineConfig.from_config()
        for name in ("width", "height", "capacity", "skip_erosion", "use_denoising", "use_upscaling"):
            assert getattr(got, name) == getattr(want, name), name
        assert got.device == "cuda"


@pytest.mark.parametrize("raw,want", [("0", False), ("false", False), ("no", False), ("", False),
                                      ("1", True), ("TRUE", True), ("yes", True), ("on", True)])
def test_bool_words(raw, want):
    # the old parser, bool(raw), read every non-empty word, "0" and "false" too, as true
    assert bool(raw) is (raw != "")
    assert config._parse(bool, raw) is want



def test_config_holds_only_the_sections_the_port_reads():
    """The port copies a section of the JAX tree only once its code reads it: no
    ``debug`` section (its tint flags and timers are read by no code, in JAX either)."""
    assert [f.name for f in dataclasses.fields(config.Config)] == ["render", "terrain"]
    assert {f.name for f in dataclasses.fields(jax_config.Config)} >= {"render", "terrain", "debug"}
    assert not hasattr(config, "DebugConfig")
