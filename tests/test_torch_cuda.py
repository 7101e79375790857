"""The four CUDA kernels (K1-K4) through the pipeline on the card vs the plain
versions on the CPU, for the 1x1-chunk area at the golden chunk (592, -368).

Every test here needs an NVIDIA GPU and nvcc: it is marked ``cuda`` and skips
without a card.  The file imports no JAX, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``tests/conftest.py`` configures JAX).  Tolerances: heightfield, weights, layers
max |diff| <= 1e-3 and >= 99.9% within 1e-5 (``pow`` and the ravine ``sin`` go
through each platform's libm); cave arrays agreement >= 0.999; blocks >= 0.9999.
"""

from __future__ import annotations

import pytest
import torch

from mega_minecraft_tpu_torch import kernels
from mega_minecraft_tpu_torch.terrain import pipeline

ORIGIN_CHUNK = (592 // 16, -368 // 16)


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
    assert kernels.launch_counts() == {"heightfield": 1, "layers": 1, "caves": 1, "fill": 1}
    assert out["blocks"].device == cuda_device
    assert (out["blocks"].cpu() == plain_area["blocks"]).double().mean() >= 0.9999
    for key in ("heightfield", "biome_weights", "layers"):
        _close(out[key].cpu(), plain_area[key])
    for key, want in plain_area["caves"].items():
        assert (out["caves"][key].cpu() == want).double().mean() >= 0.999
    assert torch.equal(out["chunk_pos"].cpu(), plain_area["chunk_pos"])
