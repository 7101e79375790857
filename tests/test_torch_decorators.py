"""The port's decorators (``place_decorators_batch``, kernel K8's plain version) vs the
JAX package's on the same inputs.

Inputs are the golden chunks (0, 0) and (592, -368): heightfield, biome weights and cave
layers from ``tests/golden/golden_chunks.npz``, the blocks before decorators (``pre_*``)
from ``tests/golden/golden_blockgrid.npz``.  The JAX side runs eagerly in exact mode
(``jax.disable_jit()`` + ``hashes.exact_scope(True)``).  Tolerance: none, the blocks are
equal (integer LCG draws, f32 sums of table constants, no libm call).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mega_minecraft_tpu.ops import hashes as jh
from mega_minecraft_tpu.terrain import decorators as j_dec
from mega_minecraft_tpu_torch.tables import from_jax_outputs
from mega_minecraft_tpu_torch.terrain import decorators
from mega_minecraft_tpu_torch.world import features_data as fd
from mega_minecraft_tpu_torch.world.blocks import Block

GOLDEN_DIR = Path(__file__).parent / "golden"
CHUNKS = [(0, 0), (592, -368)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    g = np.load(GOLDEN_DIR / "golden_chunks.npz")
    gb = np.load(GOLDEN_DIR / "golden_blockgrid.npz")
    keys = [f"{cx}_{cz}" for cx, cz in CHUNKS]
    return {
        "blocks": np.stack([gb["pre_" + k] for k in keys]).astype(np.uint8),
        "heightfield": np.stack([g["hf18_" + k][1:17, 1:17] for k in keys]),
        "biome_weights": np.stack([g["weights_" + k] for k in keys]),
        "starts": np.stack([g["cavestarts_" + k] for k in keys]).astype(np.int32),
        "ends": np.stack([g["caveends_" + k] for k in keys]).astype(np.int32),
        "bottom_biome": np.stack([g["cavebottom_" + k] for k in keys]).astype(np.int32),
        "chunk_pos": np.array(CHUNKS, np.int32),
    }


ARGS = ("blocks", "heightfield", "biome_weights", "starts", "ends", "bottom_biome", "chunk_pos")


@pytest.fixture(scope="module")
def jax_decorated(inputs):
    with jax.disable_jit(), jh.exact_scope(True):
        return np.asarray(j_dec.place_decorators_batch(*(jnp.asarray(inputs[k]) for k in ARGS)))


@pytest.fixture(scope="module")
def port_decorated(inputs):
    t = from_jax_outputs(inputs, "cpu")
    return decorators.place_decorators_batch(*(t[k] for k in ARGS))


@pytest.mark.parametrize("i", range(len(CHUNKS)), ids=[f"{cx}_{cz}" for cx, cz in CHUNKS])
def test_place_decorators_batch_equal(inputs, jax_decorated, port_decorated, i):
    assert port_decorated.dtype == torch.uint8 and port_decorated.shape == (2, 16, 16, 384)
    changed = jax_decorated[i] != inputs["blocks"][i]
    assert changed.sum() > 10, "vacuous: the reference placed no decorator in this chunk"
    np.testing.assert_array_equal(port_decorated[i].numpy(), jax_decorated[i])


def test_decorators_write_only_listed_blocks_inside_their_column(inputs, port_decorated):
    """Every changed voxel holds a decorator block (first or second) of the tables."""
    allowed = set()
    for table in (fd.BIOME_DECORATOR_GENS, fd.CAVE_DECORATOR_GENS):
        for gens in table.values():
            for g in gens:
                allowed.add(g[0])
                if g[4] != int(Block.AIR):
                    allowed.add(g[4])
    got = port_decorated.numpy()
    changed = got != inputs["blocks"]
    assert set(np.unique(got[changed]).tolist()) <= allowed


def test_decorator_constants_equal_the_reference():
    assert decorators.SEED_DECORATORS == j_dec.SEED_DECORATORS
    assert decorators.MAX_APPLY_LAYERS == j_dec.MAX_APPLY_LAYERS
    assert decorators.MAX_LAYERS == j_dec.MAX_LAYERS


def test_decorator_tables_flatten_every_gen():
    """The flattened tables the kernel reads list each gen once, in table order."""
    from mega_minecraft_tpu_torch import tables
    from mega_minecraft_tpu_torch.world import biomes as bio

    t = tables.decorator_tables()
    n = sum(len(v) for v in fd.BIOME_DECORATOR_GENS.values()) \
        + sum(len(v) for v in fd.CAVE_DECORATOR_GENS.values())
    assert len(t["DEC_BLOCK"]) == n
    for name, table, nb in (("SURF", fd.BIOME_DECORATOR_GENS, bio.NUM_BIOMES),
                            ("CAVE", fd.CAVE_DECORATOR_GENS, bio.NUM_CAVE_BIOMES)):
        for b in range(nb):
            s, c = int(t[f"DEC_{name}_START"][b]), int(t[f"DEC_{name}_COUNT"][b])
            gens = table.get(b, [])
            assert c == len(gens)
            for j, g in enumerate(gens):
                assert int(t["DEC_BLOCK"][s + j]) == g[0]
                assert np.float32(t["DEC_CHANCE"][s + j]) == np.float32(g[1])
                assert tuple(t["DEC_UNDER"][s + j][: t["DEC_N_UNDER"][s + j]]) == g[2]
                assert tuple(t["DEC_REPLACE"][s + j][: t["DEC_N_REPLACE"][s + j]]) == g[3]
                assert int(t["DEC_SECOND"][s + j]) == g[4] and bool(t["DEC_CEILING"][s + j]) == g[5]
