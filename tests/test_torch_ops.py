"""The port's plain hash / noise primitives vs the JAX package (eager, exact mode) and
vs the reference goldens, plus the port's import and build contracts.

Inputs are made with numpy from fixed seeds.  Tolerances:
- hash_u32 / seed_* / lcg_* / _sin_cr / rand*_from*: bit-equal (integer and
  correctly rounded f32 pipelines);
- simplex / fbm / worley / special_cave_noise: max |diff| <= 1e-6 (the JAX exact
  mode's correctly-rounded divide / sqrt emulation vs IEEE divide / sqrt).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mega_minecraft_tpu.ops import hashes as jh
from mega_minecraft_tpu.ops import noise as jn
from mega_minecraft_tpu_torch.kernels import _build
from mega_minecraft_tpu_torch.ops import hashes as th
from mega_minecraft_tpu_torch.ops import noise as tn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_NOISE = os.path.join(ROOT, "tests", "golden", "golden_noise.npz")

RNG_SEED = 20261016


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_exact(fn, *args, **kw):
    with jax.disable_jit(), jh.exact_scope(True):
        out = fn(*[jnp.asarray(a) for a in args], **kw)
        return jax.tree_util.tree_map(np.asarray, out)


def _port(fn, *args, **kw):
    out = fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args], **kw)
    if isinstance(out, dict):
        return {k: _np(v) for k, v in out.items()}
    return _np(out)


def _np(v):
    if isinstance(v, tuple):
        return tuple(_np(x) for x in v)
    return v.numpy()


@pytest.fixture(scope="module")
def coords():
    rng = np.random.default_rng(RNG_SEED)
    return {
        "int": rng.integers(-10**6, 10**6, (3, 4096)).astype(np.int32),
        "world": rng.uniform(-1e6, 1e6, (3, 2048)).astype(np.float32),
    }


# -- integer pipelines: bit-equal --------------------------------------------------------


@pytest.mark.parametrize("name", ["hash_u32", "seed_1", "seed_3", "seed_4"])
def test_hash_and_seeds_bit_equal(coords, name):
    c = coords["int"]
    args = {"hash_u32": (c[0],), "seed_1": (c[0],), "seed_3": (c[0], c[1], c[2]),
            "seed_4": (c[0], c[1], c[2], np.full_like(c[0], 329271348))}[name]
    want = _jax_exact(getattr(jh, name), *args).astype(np.int64)
    got = _port(getattr(th, name), *args)
    np.testing.assert_array_equal(got, want)


def test_lcg_draws_bit_equal(coords):
    c = coords["int"]
    s_j = _jax_exact(jh.seed_3, c[0], c[1], c[2])
    s_t = torch.from_numpy(s_j.astype(np.int64))
    for _ in range(3):  # three consecutive draws
        with jax.disable_jit():
            v_j, s_j = jh.lcg_u01(jnp.asarray(s_j))
            v_j, s_j = np.asarray(v_j), np.asarray(s_j)
        v_t, s_t = th.lcg_u01(s_t)
        np.testing.assert_array_equal(v_t.numpy(), v_j)
        np.testing.assert_array_equal(s_t.numpy(), s_j.astype(np.int64))
    with jax.disable_jit():
        u_j, _ = jh.lcg_uniform(jnp.asarray(s_j), -3.0, 5.0)
    u_t, _ = th.lcg_uniform(s_t, -3.0, 5.0)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))


def test_sin_cr_bit_equal():
    d = np.random.default_rng(RNG_SEED + 1).uniform(-6.6e9, 6.6e9, 100_000).astype(np.float32)
    want = _jax_exact(jh._sin_cr, d)
    got = _port(th._sin_cr, d)
    assert (got.view(np.uint32) != want.view(np.uint32)).sum() == 0


@pytest.mark.parametrize(
    "name,nargs",
    [("rand1_from1", 1), ("rand1_from2", 2), ("rand1_from3", 3), ("rand2_from2", 2),
     ("rand2_from3", 3), ("rand3_from2", 2), ("rand3_from3", 3)],
)
def test_sin_dot_hashes_bit_equal(coords, name, nargs):
    x = coords["world"][:nargs] * np.float32(1e-3)
    want = _jax_exact(getattr(jh, name), *x)
    got = _port(getattr(th, name), *x)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


# -- float noise: max |diff| <= 1e-6 ----------------------------------------------------


@pytest.mark.parametrize(
    "name,nargs,kw",
    [("simplex2", 2, {}), ("simplex3", 3, {}), ("fbm2", 2, {"octaves": 3}),
     ("fbm3", 3, {"octaves": 2}), ("special_cave_noise", 3, {})],
)
def test_noise_close(coords, name, nargs, kw):
    x = coords["world"][:nargs, :512] * np.float32(0.01)
    want = _jax_exact(getattr(jn, name), *x, **kw)
    got = _port(getattr(tn, name), *x, **kw)
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("name,nargs", [("worley2", 2), ("worley3", 3)])
def test_worley_close(coords, name, nargs):
    x = coords["world"][:nargs, :256] * np.float32(0.01)
    want = _jax_exact(getattr(jn, name), *x, want_color=True, want_edge=True)
    got = _port(getattr(tn, name), *x, want_color=True, want_edge=True)
    assert np.abs(got["f1"] - want["f1"]).max() <= 1e-6
    assert np.abs(got["edge"] - want["edge"]).max() <= 1e-6
    for g, w in zip(got["color"], want["color"]):
        assert np.abs(g - w).max() <= 1e-6


def test_smoothstep_descending_edges():
    x = np.linspace(-0.05, 0.05, 101, dtype=np.float32)
    want = _jax_exact(jn.smoothstep, np.float32(0.01), np.float32(-0.02), x)
    np.testing.assert_array_equal(tn.smoothstep(0.01, -0.02, torch.from_numpy(x)).numpy(), want)


# -- the reference goldens at tests/test_golden.py's tolerances ----------------------------


@pytest.fixture(scope="module")
def golden_noise():
    return np.load(GOLDEN_NOISE)


def _grid(fx, fy, cx, cy, n=48):
    i = np.arange(n, dtype=np.float32)
    x = (i * np.float32(fx) + np.float32(cx))[None, :] * np.ones((n, 1), np.float32)
    y = (i * np.float32(fy) + np.float32(cy))[:, None] * np.ones((1, n), np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def test_golden_simplex2(golden_noise):
    got = tn.simplex2(*_grid(0.37, 0.53, -8.9, -7.1)).numpy()
    np.testing.assert_allclose(got, golden_noise["simplex2"], atol=2e-4)


def test_golden_fbm4_2d(golden_noise):
    got = tn.fbm2(*_grid(0.29, 0.41, -5.3, -6.7), octaves=4).numpy()
    np.testing.assert_allclose(got, golden_noise["fbm4_2d"], atol=5e-4)


def test_golden_fbm5_3d(golden_noise):
    i = np.arange(48, dtype=np.float32)
    x = (i * np.float32(0.31) - np.float32(4.9))[None, :] * np.ones((48, 1), np.float32)
    y = (i * np.float32(0.23) - np.float32(3.8))[:, None] * np.ones((1, 48), np.float32)
    z = (i[None, :] * np.ones((48, 1), np.float32) + i[:, None] * np.ones((1, 48), np.float32))
    z = z * np.float32(0.17)
    got = tn.fbm3(*map(torch.from_numpy, (x, y, z)), octaves=5).numpy()
    np.testing.assert_allclose(got, golden_noise["fbm5_3d"], atol=5e-4)


def test_golden_worley2(golden_noise):
    out = tn.worley2(*_grid(0.43, 0.37, -9.2, -8.4), want_edge=True)
    d1 = np.abs(out["f1"].numpy() - golden_noise["worley2_f1"])
    d2 = np.abs(out["edge"].numpy() - golden_noise["worley2_edge"])
    assert np.percentile(d1, 99) < 5e-3
    assert (d1 < 1e-2).mean() > 0.99
    assert (d2 < 1e-2).mean() > 0.98


def test_golden_special_cave_noise(golden_noise):
    i = np.arange(48, dtype=np.float32)
    ii = i[None, :] * np.ones((48, 1), np.float32)
    jj = i[:, None] * np.ones((1, 48), np.float32)
    x = ii * np.float32(0.21) - np.float32(4.4)
    y = jj * np.float32(0.19) - np.float32(3.3)
    z = (ii * jj) * np.float32(0.01)
    d = np.abs(tn.special_cave_noise(*map(torch.from_numpy, (x, y, z))).numpy()
               - golden_noise["special_cave"])
    assert np.median(d) < 5e-3
    assert np.percentile(d, 95) < 5e-2
    assert np.percentile(d, 99) < 0.1
    assert (d < 5e-2).mean() > 0.97


def test_golden_rand1_from2(golden_noise):
    i = np.arange(48, dtype=np.float32)
    x = (i - 23)[None, :] * np.ones((48, 1), np.float32)
    y = (i - 17)[:, None] * np.ones((1, 48), np.float32)
    d = np.abs(th.rand1_from2(torch.from_numpy(x), torch.from_numpy(y)).numpy()
               - golden_noise["rand1from2"])
    d = np.minimum(d, 1 - d)  # fract wrap distance
    assert np.percentile(d, 99) < 1e-2


def test_golden_lcg_u01(golden_noise):
    i = np.arange(48, dtype=np.int32)
    ii = torch.from_numpy(i[None, :] * np.ones((48, 1), np.int32))
    jj = torch.from_numpy(i[:, None] * np.ones((1, 48), np.int32))
    v, _ = th.lcg_u01(th.seed_3(ii, jj, 42))
    np.testing.assert_array_equal(v.numpy(), golden_noise["lcg_u01"])


# -- package contracts ---------------------------------------------------------------------


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import mega_minecraft_tpu_torch.terrain.pipeline\n"
        "import mega_minecraft_tpu_torch.app.generate_demo\n"
        "import mega_minecraft_tpu_torch.kernels._build\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'triton' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


def test_ids_header_covers_every_id():
    from mega_minecraft_tpu.world import biomes as bio
    from mega_minecraft_tpu.world.blocks import Block

    header = _build.ids_header()
    for b in Block:
        assert f"#define BLOCK_{b.name} {int(b)}\n" in header
    for b in bio.Biome:
        assert f"#define BIOME_{b.name} {int(b)}\n" in header
    for b in bio.CaveBiome:
        assert f"#define CAVE_{b.name} {int(b)}\n" in header
    assert f"#define SEA_LEVEL {bio.SEA_LEVEL}\n" in header


def test_build_flags_and_hash():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags
    assert _build.source_hash() == _build.source_hash()
    assert sorted(p.name for p in _build._sources()) == [
        "accumulate.cu", "brickmap.cu", "caves.cu", "debug.cu", "decorators.cu", "denoise.cu",
        "erosion.cu", "features.cu", "fill.cu", "heightfield.cu", "layers.cu", "placements.cu",
        "present.cu", "reproject.cu", "tracer.cu"]
    # every C entry point the wrappers call is declared in one of the sources
    text = "".join(p.read_text() for p in _build._sources())
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text, name


def test_render_tables_header_matches_the_numpy_tables():
    from mega_minecraft_tpu_torch.render import materials

    header = _build.render_tables_header()
    for name in ("EMPTY_BASE 140", "DIST_CAP 63", "SKY_R 8", "MACRO_SCALE 4"):
        assert f"#define {name}\n" in header
    props = ", ".join(f"{int(v)}u" for v in materials.BLOCK_PROPS)
    assert f"uint32_t BLOCK_PROPS_TAB[140] = {{{props}}};" in header
    ior = ", ".join(repr(float(v)) + "f" for v in materials.MAT_IOR)
    assert f"float MAT_IOR_TAB[6] = {{{ior}}};" in header
    for name in ("RENDER_SOLID_TAB[140]", "MAT_SPECULAR_TAB[6]", "MAT_WAVY_TAB[6]", "MAT_ROUGHNESS_TAB[6]"):
        assert f" {name} = {{" in header, name


def test_feature_tables_header_covers_the_feature_half():
    from mega_minecraft_tpu.world import features_data as fd

    header = _build.feature_tables_header()
    for f in fd.Feature:
        assert f"#define FEAT_{f.name} {int(f)}\n" in header
    for f in fd.CaveFeature:
        assert f"#define CAVEFEAT_{f.name} {int(f)}\n" in header
    for name in ("FEATURE_HEIGHT_BOUNDS[21][2]", "CAVE_FEATURE_HEIGHT_BOUNDS[10][2]",
                 "SG_CHANCE[24][4]", "CG_MIN_HEIGHT[5][3]", "GATHER_OFFSETS[49][2]",
                 "SURFACE_WINDOW[21][2]", "CAVE_WINDOW[10][2]", "DEC_CHANCE[65]"):
        assert f" {name} = {{" in header, name
    # an f32 table value is written so that it reads back as the same f32
    assert "0.6499999761581421f" in header  # CORAL's chance 0.65
