"""The port's featured area vs the reference's block-grid golden.

``tests/golden/golden_blockgrid.npz`` holds the centre chunk of a reference-computed
featured 7x7 area (skip-erosion semantics, per-consumer gather caps included): ``pre_*``
after the fill and the SDF features, ``post_*`` after the decorators.  The port's plain
chain generates the same 7x7 area around chunk (0, 0) on the CPU, and its centre chunk
must equal ``post_0_0`` block for block.  This is the port's default-tier smoke of the
bit-exactness flagship: a regression of it must show in a plain ``pytest tests/`` run.
``tests/test_golden.py`` holds the JAX package to the same golden, and on a card
``python3 chip_smoke.py`` holds the kernels to all four chunks.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from mega_minecraft_tpu_torch.terrain import pipeline

BLOCKGRID_NPZ = os.path.join(os.path.dirname(__file__), "golden", "golden_blockgrid.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_block_grid_origin_equals_golden():
    golden = np.load(BLOCKGRID_NPZ)
    area = pipeline.generate_area(-3, -3, 7, 7, features=True, device="cpu")
    got = area["blocks"][3, 3].numpy()
    want = golden["post_0_0"]
    agree = float((got == want).mean())
    if agree < 1.0:
        vals, cnts = np.unique(want[got != want], return_counts=True)
        raise AssertionError(
            f"block grid agreement {agree:.6f} < 1.0 at (0,0); agreement vs the "
            f"pre-decorator golden {float((got == golden['pre_0_0']).mean()):.6f}; "
            f"most-mismatched reference blocks {dict(zip(vals.tolist(), cnts.tolist()))}"
        )
