"""The port's zone erosion (plain version of kernel K9) and the unfixed layers it erodes,
vs the JAX package.

- ``erode_zone_plain`` on both ``golden_erosion.npz`` inputs: equal to JAX
  ``erosion.erode_zone`` (jitted on the CPU) bit for bit, with the same sweep counts per
  layer as the JAX while_loops take, and within tests/test_golden.py's gate (atol 2e-3)
  of the reference's eroded grids;
- ``gather_zone_layers`` / ``scatter_zone_layers`` and the slot-table stage
  ``erode_zone_slots_plain`` on a seeded [24, 24] grid: equal to JAX's gather, erode,
  scatter and fix (the scheduler's ``_stage_erosion`` and ``generate_area``'s order);
- K2's plain path with ``fix_backward=False`` on the golden chunks: equal to JAX
  ``generate_layers`` (eager, exact mode) to max |diff| <= 1e-3 with >= 99.9% within
  1e-5 (the f32 fBm chains; ``pow`` goes through each library's libm), and K2s's plain
  path (3x3 slot table) equal to K2's.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mega_minecraft_tpu.ops import hashes as jh
from mega_minecraft_tpu.terrain import erosion as j_erosion
from mega_minecraft_tpu.terrain import layers as j_layers
from mega_minecraft_tpu_torch.terrain import erosion, gather, layers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
#: sweeps per layer, top layer first, that the JAX while_loops take on the two inputs
SWEEPS = {"0_0": [5, 1, 2, 2, 8, 2, 5, 2], "400_-560": [1, 3, 4, 13, 8, 7, 11, 4]}
SEED = 20261016


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden_erosion():
    return np.load(os.path.join(GOLDEN, "golden_erosion.npz"))


@pytest.mark.parametrize("key", list(SWEEPS))
def test_erode_zone_equals_jax_bit_for_bit(golden_erosion, key):
    inp = golden_erosion[f"input_{key}"]
    want = np.asarray(j_erosion.erode_zone(jnp.asarray(inp)))
    sweeps = []
    got = erosion.erode_zone_plain(torch.from_numpy(inp), sweeps).numpy()
    assert (np.abs(got[:8] - inp[:8]) > 1e-6).mean() > 0.01, "vacuous: erosion changed nothing"
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert sweeps == SWEEPS[key]
    ref = golden_erosion[f"eroded_{key}"]
    np.testing.assert_allclose(got[:8], ref[:8], atol=2e-3, rtol=0)
    np.testing.assert_array_equal(got[8], ref[8])
    # the dispatching entry point takes the plain version for a CPU tensor
    assert torch.equal(erosion.erode_zone(torch.from_numpy(inp)), torch.from_numpy(got))


def _seeded_grid(rng):
    """A [24, 24] grid of chunks whose eroded layers descend from a rough heightfield."""
    hf = rng.uniform(80.0, 200.0, (24, 24, 16, 16)).astype(np.float32)
    lg = rng.uniform(0.0, 60.0, (24, 24, 20, 16, 16)).astype(np.float32)
    thick = rng.uniform(0.0, 6.0, (24, 24, 8, 16, 16)).astype(np.float32)
    lg[:, :, 12:] = hf[:, :, None] - np.cumsum(thick[:, :, ::-1], axis=2)[:, :, ::-1]
    return lg, hf


def test_gather_scatter_and_slot_stage_equal_jax():
    rng = np.random.default_rng(SEED)
    lg, hf = _seeded_grid(rng)
    g_want = np.asarray(j_erosion.gather_zone_layers(jnp.asarray(lg), jnp.asarray(hf)))
    g_got = erosion.gather_zone_layers(torch.from_numpy(lg), torch.from_numpy(hf)).numpy()
    np.testing.assert_array_equal(g_got, g_want)
    eroded = rng.uniform(0.0, 200.0, (9, 384, 384)).astype(np.float32)
    s_want = np.asarray(j_erosion.scatter_zone_layers(jnp.asarray(lg[6:18, 6:18]), jnp.asarray(eroded)))
    s_got = erosion.scatter_zone_layers(torch.from_numpy(lg[6:18, 6:18]), torch.from_numpy(eroded))
    np.testing.assert_array_equal(s_got.numpy(), s_want)

    # the slot-table stage: the grid's chunks at shuffled rows of a larger table
    n = 24 * 24 + 9
    rows = rng.permutation(n)[: 24 * 24].astype(np.int32)
    table_l = rng.uniform(0.0, 1.0, (n, 20, 16, 16)).astype(np.float32)
    table_h = np.zeros((n, 16, 16), np.float32)
    table_l[rows] = lg.reshape(-1, 20, 16, 16)
    table_h[rows] = hf.reshape(-1, 16, 16)
    eroded_j = j_erosion.erode_zone(j_erosion.gather_zone_layers(jnp.asarray(lg), jnp.asarray(hf)))
    core = j_erosion.scatter_zone_layers(jnp.asarray(lg[6:18, 6:18]), eroded_j)
    want_core = np.asarray(j_layers.fix_backward_stratified(core.reshape(-1, 20, 16, 16)))
    gslots = torch.from_numpy(rows.reshape(24, 24))
    for fix_all in (False, True):
        got = erosion.erode_zone_slots(torch.from_numpy(table_l.copy()), torch.from_numpy(table_h),
                                       gslots, fix_all=fix_all).numpy()
        core_rows = rows.reshape(24, 24)[6:18, 6:18].reshape(-1)
        np.testing.assert_array_equal(got[core_rows], want_core)
        ring = np.setdiff1d(rows, core_rows)
        want_ring = table_l[ring]
        if fix_all:
            want_ring = np.asarray(j_layers.fix_backward_stratified(jnp.asarray(want_ring)))
        np.testing.assert_array_equal(got[ring], want_ring)
        outside = np.setdiff1d(np.arange(n), rows)
        np.testing.assert_array_equal(got[outside], table_l[outside])


def _close(got, want):
    d = np.abs(got.astype(np.float64) - want)
    assert d.max() <= 1e-3 and (d <= 1e-5).mean() >= 0.999, (d.max(), (d <= 1e-5).mean())


@pytest.mark.parametrize("cx,cz", [(0, 0), (592, -368)])
def test_unfixed_layers_equal_jax_and_slot_path(cx, cz):
    g = np.load(os.path.join(GOLDEN, "golden_chunks.npz"))
    hf18, w = g[f"hf18_{cx}_{cz}"], g[f"weights_{cx}_{cz}"]
    pos = np.array([[cx, cz]], np.int32)
    with jax.disable_jit(), jh.exact_scope(True):
        want = np.asarray(j_layers.generate_layers(jnp.asarray(hf18[None]), jnp.asarray(w[None]),
                                                   jnp.asarray(pos)))
    # the 18x18 window as a 3x3 halo of chunks (only the ring the window needs is set)
    full = torch.zeros((48, 48))
    full[15:33, 15:33] = torch.from_numpy(hf18)
    hf_h = gather.split_chunk_grid(full, 3, 3).reshape(9, 16, 16).contiguous()
    w_h = torch.zeros((9, 24, 16, 16))
    w_h[4] = torch.from_numpy(w)
    pos_h = torch.tensor([[cx + 16 * dx, cz + 16 * dz] for dz in (-1, 0, 1) for dx in (-1, 0, 1)],
                         dtype=torch.int32)
    got = layers.layers_from_halo(hf_h, w_h, pos_h, 1, 1, fix_backward=False)["layers"]
    _close(got.numpy(), want)
    fixed = layers.layers_from_halo(hf_h, w_h, pos_h, 1, 1)["layers"]
    assert torch.equal(fixed, layers.fix_backward_stratified(got))

    # K2s's plain path: the same chunk through a 3x3 slot table into row 11 of a table
    order = torch.tensor([5, 9, 2, 7, 11, 0, 3, 8, 6])
    d_hf = torch.zeros((12, 16, 16))
    d_w = torch.zeros((12, 24, 16, 16))
    d_hf[order] = hf_h
    d_w[order] = w_h
    for fix in (False, True):
        d_layers = torch.full((12, 20, 16, 16), 7.0)
        layers.layers_slots(d_layers, d_hf, d_w, order.to(torch.int32).reshape(1, 3, 3),
                            torch.tensor([11], dtype=torch.int32), torch.from_numpy(pos), fix)
        assert torch.equal(d_layers[11:12], fixed if fix else got)
        assert bool((d_layers[:11] == 7.0).all())
