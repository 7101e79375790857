"""Launch wrappers of the four hand-written CUDA kernels (K1-K4).

Each wrapper checks device, dtype, shape and contiguity of its inputs, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises if the C
entry point returns a non-zero ``cudaError_t``, and adds one to its launch count.
The library is built and loaded at the first launch (``_build.load``), never at
import.  The stage modules (``terrain/*.py``) call these for CUDA tensors and their
plain versions for CPU tensors.
"""

from __future__ import annotations

import torch

from mega_minecraft_tpu.world import biomes as bio

from ..tables import CARVE_Y_MAX, Y_SIZE, load_tables
from . import _build

#: launches per kernel since the last reset (plain integers, read by chip_smoke.py)
LAUNCHES = {"heightfield": 0, "layers": 0, "caves": 0, "fill": 0}

N_BIOMES = bio.NUM_BIOMES
N_MAT = bio.NUM_MATERIALS
N_LAYERS = bio.MAX_CAVE_LAYERS_PER_COLUMN


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def require_cpu(t: torch.Tensor) -> None:
    """The plain versions serve CPU tensors only; any other device raises."""
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain path for device {t.device}")


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(name: str, fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel {name} failed to launch: cudaError_t {err}")
    LAUNCHES[name] += 1


def _p(t: torch.Tensor) -> int:
    return t.data_ptr()


def heightfield(chunk_pos):
    """K1: [B, 2] i32 -> (heightfield [B, 16, 16] f32, weights [B, 24, 16, 16] f32)."""
    dev = chunk_pos.device
    B = chunk_pos.shape[0]
    _check(chunk_pos, "chunk_pos", torch.int32, (B, 2), dev)
    tb = load_tables(dev)
    hf = torch.empty((B, 16, 16), dtype=torch.float32, device=dev)
    w = torch.empty((B, N_BIOMES, 16, 16), dtype=torch.float32, device=dev)
    if B:
        with torch.cuda.device(dev):
            _launch("heightfield", _build.load().mmt_heightfield,
                    _p(chunk_pos), B, _p(tb.biome_noise_weights), _p(hf), _p(w))
    return hf, w


def layers(hf_halo, w_halo, pos_halo, ncx: int, ncz: int):
    """K2: halo'd heightfield / weights / origins of a (ncz+2) x (ncx+2) grid ->
    dict(layers [B,20,16,16] fixed, heightfield, biome_weights, chunk_pos) of the
    B = ncz*ncx inner chunks (the 18x18 gather is folded into the kernel)."""
    dev = hf_halo.device
    H = (ncz + 2) * (ncx + 2)
    B = ncz * ncx
    _check(hf_halo, "hf_halo", torch.float32, (H, 16, 16), dev)
    _check(w_halo, "w_halo", torch.float32, (H, N_BIOMES, 16, 16), dev)
    _check(pos_halo, "pos_halo", torch.int32, (H, 2), dev)
    tb = load_tables(dev)
    out = {
        "layers": torch.empty((B, N_MAT, 16, 16), dtype=torch.float32, device=dev),
        "heightfield": torch.empty((B, 16, 16), dtype=torch.float32, device=dev),
        "biome_weights": torch.empty((B, N_BIOMES, 16, 16), dtype=torch.float32, device=dev),
        "chunk_pos": torch.empty((B, 2), dtype=torch.int32, device=dev),
    }
    if B:
        with torch.cuda.device(dev):
            _launch("layers", _build.load().mmt_layers,
                    _p(hf_halo), _p(w_halo), _p(pos_halo), ncx, ncz,
                    _p(tb.biome_material_weights), _p(tb.material_thickness),
                    _p(tb.material_amplitude_or_tan_repose), _p(tb.material_scale_or_max_slope),
                    _p(tb.dir_vecs_2d), _p(out["layers"]), _p(out["heightfield"]),
                    _p(out["biome_weights"]), _p(out["chunk_pos"]))
    return out


def caves(heightfield, biome_weights, chunk_pos):
    """K3: -> dict of [B, 16, 16, 32] i32 starts / ends / bottom_biome / top_biome."""
    dev = heightfield.device
    B = heightfield.shape[0]
    _check(heightfield, "heightfield", torch.float32, (B, 16, 16), dev)
    _check(biome_weights, "biome_weights", torch.float32, (B, N_BIOMES, 16, 16), dev)
    _check(chunk_pos, "chunk_pos", torch.int32, (B, 2), dev)
    tb = load_tables(dev)
    carved = torch.empty((B, 256, CARVE_Y_MAX), dtype=torch.uint8, device=dev)
    out = {
        k: torch.empty((B, 16, 16, N_LAYERS), dtype=torch.int32, device=dev)
        for k in ("starts", "ends", "bottom_biome", "top_biome")
    }
    if B:
        with torch.cuda.device(dev):
            _launch("caves", _build.load().mmt_caves,
                    _p(heightfield), _p(biome_weights), _p(chunk_pos), B,
                    _p(tb.cave_biome_noise_weights), _p(carved),
                    _p(out["starts"]), _p(out["ends"]), _p(out["bottom_biome"]),
                    _p(out["top_biome"]))
    return out


def fill(heightfield, biome_weights, layers, cave_starts, cave_ends, chunk_pos):
    """K4: -> blocks [B, 16, 16, 384] u8 ([z, x, y])."""
    dev = heightfield.device
    B = heightfield.shape[0]
    _check(heightfield, "heightfield", torch.float32, (B, 16, 16), dev)
    _check(biome_weights, "biome_weights", torch.float32, (B, N_BIOMES, 16, 16), dev)
    _check(layers, "layers", torch.float32, (B, N_MAT, 16, 16), dev)
    _check(cave_starts, "cave_starts", torch.int32, (B, 16, 16, N_LAYERS), dev)
    _check(cave_ends, "cave_ends", torch.int32, (B, 16, 16, N_LAYERS), dev)
    _check(chunk_pos, "chunk_pos", torch.int32, (B, 2), dev)
    tb = load_tables(dev)
    blocks = torch.empty((B, 16, 16, Y_SIZE), dtype=torch.uint8, device=dev)
    if B:
        with torch.cuda.device(dev):
            _launch("fill", _build.load().mmt_fill,
                    _p(heightfield), _p(biome_weights), _p(layers), _p(cave_starts),
                    _p(cave_ends), _p(chunk_pos), B, _p(tb.grass_blocks),
                    _p(tb.material_block), _p(tb.cave_biome_noise_weights), _p(blocks))
    return blocks
