"""The CUDA kernels through the pipeline on the card vs the plain versions: K1-K4 for
the 1x1-chunk area at the golden chunk (592, -368) against the plain versions on the
CPU, K1-K8 for the featured 5x5 bench area against the plain chain run on the card, K9
on the two ``golden_erosion.npz`` grids against the plain erosion on the CPU (bit for
bit, with the same sweep counts), and a radius-8 streaming drain (K1, K2s, K3, K5, K6,
K7's pre-kernel, K4, K7s, K8) whose filled chunks must equal the featured area path
over all their sources.

Every test here needs an NVIDIA GPU and nvcc: it is marked ``cuda`` and skips
without a card.  The file imports no JAX, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``tests/conftest.py`` configures JAX).  Tolerances: heightfield, weights, layers
max |diff| <= 1e-3 and >= 99.9% within 1e-5 (``pow`` and the ravine ``sin`` go
through each platform's libm); cave arrays agreement >= 0.999; blocks >= 0.9999.  The
featured 5x5 area shares the card's libm with its plain chain: every field of the
placement lists and the blocks are equal.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from mega_minecraft_tpu_torch import kernels
from mega_minecraft_tpu_torch.terrain import (caves, decorators, erosion, feature_placement, features,
                                              fill, heightfield, layers, pipeline, scheduler)

ORIGIN_CHUNK = (592 // 16, -368 // 16)
GOLDEN_EROSION = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                              "golden_erosion.npz")


def _pos_halo(device="cpu"):
    return pipeline.chunk_positions(ORIGIN_CHUNK[0] - 1, ORIGIN_CHUNK[1] - 1, 3, 3, device=device)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run python3 chip_smoke.py there)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def plain_area():
    return pipeline.generate_area_fused(_pos_halo(), 1, 1)


def _close(got, want):
    d = (got.double() - want.double()).abs()
    assert float(d.max()) <= 1e-3
    assert float((d <= 1e-5).double().mean()) >= 0.999


@pytest.mark.cuda
def test_kernels_match_plain_on_gpu(cuda_device, plain_area):
    kernels.reset_launch_counts()
    out = pipeline.generate_area_fused(_pos_halo(cuda_device), 1, 1)
    torch.cuda.synchronize()
    gen = ("heightfield", "layers", "caves", "fill")
    assert kernels.launch_counts() == {k: int(k in gen) for k in kernels.LAUNCHES}
    assert out["blocks"].device == cuda_device
    assert (out["blocks"].cpu() == plain_area["blocks"]).double().mean() >= 0.9999
    for key in ("heightfield", "biome_weights", "layers"):
        _close(out[key].cpu(), plain_area[key])
    for key, want in plain_area["caves"].items():
        assert (out["caves"][key].cpu() == want).double().mean() >= 0.999
    assert torch.equal(out["chunk_pos"].cpu(), plain_area["chunk_pos"])


@pytest.mark.cuda
def test_featured_5x5_matches_plain_chain_on_gpu(cuda_device):
    pos = pipeline.chunk_positions(-1, -1, 7, 7, device=cuda_device)
    kernels.reset_launch_counts()
    out = pipeline.generate_area_fused(pos, 5, 5, features=True)
    torch.cuda.synchronize()
    unused = ("erosion", "layers_slots", "features_slots")  # erosion and the scheduler's kernels
    assert kernels.launch_counts() == {k: int(k not in unused) for k in kernels.LAUNCHES}

    hf, w = heightfield.generate_heightfield_plain(pos)
    st = layers.layers_from_halo_plain(hf, w, pos, 5, 5)
    hf_in, w_in, pos_in = st["heightfield"], st["biome_weights"], st["chunk_pos"]
    cv = caves.generate_caves_plain(hf_in, w_in, pos_in)
    blocks = fill.fill_chunks_plain(hf_in, w_in, st["layers"], cv["starts"], cv["ends"], pos_in)
    pl = feature_placement.generate_placements_plain(
        hf_in, w_in, st["layers"], cv["starts"], cv["ends"], cv["bottom_biome"], cv["top_biome"], pos_in)
    lists = feature_placement.compact_placements_plain(pl, pos_in)
    featured = features.apply_features_area_plain(blocks, lists["surface"], lists["cave"], pos_in, 5, 5)
    want = decorators.place_decorators_batch_plain(
        featured, hf_in, w_in, cv["starts"], cv["ends"], cv["bottom_biome"], pos_in)
    assert int((featured != blocks).sum()) > 0 and int((want != featured).sum()) > 0
    for kind in ("surface", "cave"):
        assert sorted(out["placements"][kind]) == sorted(lists[kind])
        for field, value in lists[kind].items():
            assert torch.equal(out["placements"][kind][field], value), (kind, field)
    assert torch.equal(out["blocks"], want)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["0_0", "400_-560"])
def test_erosion_kernel_matches_plain_on_gpu(cuda_device, key):
    grid = np.load(GOLDEN_EROSION)[f"input_{key}"]
    sweeps = []
    want = erosion.erode_zone_plain(torch.from_numpy(grid), sweeps)
    kernels.reset_launch_counts()
    got, iters = kernels.erode_zone(torch.from_numpy(grid).to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["erosion"] == 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert iters.cpu().tolist() == sweeps


@pytest.mark.cuda
def test_radius8_drain_matches_area_path_on_gpu(cuda_device):
    s = scheduler.make_scheduler(1024, 8, skip_erosion=True, native=True, device=cuda_device)
    s.set_player_pos(0.0, 0.0)
    kernels.reset_launch_counts()
    s.drain()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in ("heightfield", "layers_slots", "caves", "placements", "compact_placements",
                 "feature_streams", "fill", "features_slots", "decorators"):
        assert counts[name] > 0, name
    assert counts["layers"] == counts["features"] == counts["erosion"] == 0
    # the chunks within 4 of the centre are filled; their sources lie within 7
    area = pipeline.generate_area_fused(pipeline.chunk_positions(-8, -8, 17, 17, device=cuda_device),
                                        15, 15, features=True)
    blocks = area["blocks"].reshape(15, 15, 16, 16, 384)
    for dz in range(-4, 5):
        for dx in range(-4, 5):
            assert s.state_at((dx, dz)) >= int(scheduler.ChunkState.FILLED)
            got = s.t.d_blocks[s.slot_for((dx, dz))]
            assert torch.equal(got, blocks[7 + dz, 7 + dx]), (dx, dz)
