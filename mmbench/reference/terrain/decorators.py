"""Stage 6: decorators, the 1-2-block flora and crystals placed after the features
(kernel K8).

Port of ``mega_minecraft_tpu/terrain/decorators.py:52-202``.  Per chunk one sequential
minstd stream; a column consumes 2 + 2 x (its drawing cave layers) draws, so every
draw's stream position is a prefix sum over the 256 columns in z*16+x order and its
value is one LCG jump.  Per column: one weighted surface decorator (the first gen whose
cumulative chance crosses the draw), then per cave layer every floor / ceiling gen of
the layer's bottom biome whose cumulative chance exceeds the layer's draw (the
reference never sets its placed flags, so later gens overwrite).  Each placement checks
the replaceable block, the under-block (solid, and on the gen's whitelist) and an
optional second block for tall plants.  All writes stay inside the column.

``place_decorators_batch`` dispatches on the device: CUDA tensors go to
``csrc/decorators.cu`` (one thread per column, applying its placements in order), CPU
tensors to the plain version, which applies each gen to all columns at once with
gathers and scatters along y.
"""

from __future__ import annotations

import torch

from ..ops import hashes
from ..tables import Y_SIZE
from ..world import biomes as bio
from ..world import features_data as fd
from ..world.blocks import NUM_NON_SOLID_BLOCKS, Block
from .fill import random_biome

I32 = torch.int32
U8 = torch.uint8

SEED_DECORATORS = 7589341
MAX_LAYERS = bio.MAX_CAVE_LAYERS_PER_COLUMN
#: stream positions a chunk can reach: 256 columns x (2 + 2 * 32) draws, + slack
LCG_POW_LEN = 16900
#: cave layers that receive decorators (the draws still cover all 32)
MAX_APPLY_LAYERS = 8


def _isin(block, ids):
    out = torch.zeros_like(block, dtype=torch.bool)
    for b in ids:
        out = out | (block == int(b))
    return out


def _try_place(blocks, active, y, gen):
    """tryPlaceSingleDecorator for every column at once; blocks [N, 384] u8."""
    dec_block, _chance, under, replace, second, ceiling = gen

    def read(yy):
        return torch.gather(blocks, 1, yy.clamp(0, Y_SIZE - 1).long()[:, None])[:, 0]

    def write(b, yy, value, ok):
        idx = yy.clamp(0, Y_SIZE - 1).long()[:, None]
        new = torch.where(ok, torch.tensor(value, dtype=U8, device=b.device), torch.gather(b, 1, idx)[:, 0])
        return b.scatter(1, idx, new[:, None])

    ok = active & (y >= 0) & (y <= Y_SIZE - 1) & _isin(read(y), replace)
    u_off = 1 if ceiling else -1
    uy = y + u_off
    ub = read(uy)
    ok = ok & (uy >= 0) & (uy <= Y_SIZE - 1) & (ub.to(I32) >= NUM_NON_SOLID_BLOCKS)
    if under:
        ok = ok & _isin(ub, under)
    if second != int(Block.AIR):
        oy = y - u_off
        ok = ok & (oy >= 0) & (oy <= Y_SIZE - 1) & _isin(read(oy), replace)
        blocks = write(blocks, oy, second, ok)
    return write(blocks, y, dec_block, ok)


def place_decorators_batch_plain(blocks, heightfield, biome_weights, cave_starts, cave_ends,
                                 cave_bottom_biome, chunk_pos):
    """Plain decorators for [B] chunks: blocks [B,16,16,384] u8, heightfield [B,16,16]
    f32, biome_weights [B,24,16,16] f32, cave arrays [B,16,16,32] i32, chunk_pos [B,2]
    i32 -> blocks [B,16,16,384] u8."""
    B = blocks.shape[0]
    dev = blocks.device
    w_last = biome_weights.permute(0, 2, 3, 1).reshape(B, 256, bio.NUM_BIOMES)
    starts = cave_starts.reshape(B, 256, MAX_LAYERS)
    is_end = starts == Y_SIZE
    # the reference's loop breaks at the first start == 384; later layers never draw
    draws_layer = ~is_end & ~(torch.cumsum(is_end.to(I32), -1) > 0)

    zero = torch.zeros_like(chunk_pos[:, 0])
    state0 = hashes.seed_4(chunk_pos[:, 0], zero, chunk_pos[:, 1], SEED_DECORATORS)[:, None]
    k_col = 2 + 2 * draws_layer.sum(-1)  # [B, 256]
    col_base = torch.cumsum(k_col, -1) - k_col
    drawn_before = torch.cumsum(draws_layer.to(torch.int64), -1) - draws_layer.to(torch.int64)
    pos_bottom = col_base[..., None] + 2 + 2 * drawn_before
    ptab = torch.as_tensor(hashes.lcg_pow_table(LCG_POW_LEN), device=dev)
    r_biome = hashes.lcg_value_at(state0, col_base, ptab).reshape(-1)
    r_surface = hashes.lcg_value_at(state0, col_base + 1, ptab).reshape(-1)
    r_bottom = hashes.lcg_value_at(state0[..., None], pos_bottom, ptab).reshape(-1, MAX_LAYERS)
    r_top = hashes.lcg_value_at(state0[..., None], pos_bottom + 1, ptab).reshape(-1, MAX_LAYERS)

    n = B * 256
    biome = random_biome(w_last.reshape(n, -1), r_biome)
    blocks = blocks.reshape(n, Y_SIZE)  # row = column (z = c // 16, x = c % 16)
    ground_y = heightfield.reshape(n).to(I32) + 1

    # surface decorators: the first gen whose cumulative chance crosses the draw
    for b in range(bio.NUM_BIOMES):
        gens = fd.BIOME_DECORATOR_GENS.get(b, [])
        if not gens:
            continue
        is_b = biome == b
        chosen_before = torch.zeros_like(is_b)
        running = torch.zeros_like(r_surface)
        for gen in gens:
            running = running + gen[1]
            choose = is_b & ~chosen_before & (r_surface < running)
            blocks = _try_place(blocks, choose, ground_y, gen)
            chosen_before = chosen_before | choose

    # cave decorators: every gen past the crossing point places too
    draws_layer = draws_layer.reshape(n, MAX_LAYERS)
    starts = starts.reshape(n, MAX_LAYERS)
    ends = cave_ends.reshape(n, MAX_LAYERS)
    cbb = cave_bottom_biome.reshape(n, MAX_LAYERS)
    for li in range(MAX_APPLY_LAYERS):
        floor_y = starts[:, li] + 1
        ceil_y = ends[:, li]
        for b in range(bio.NUM_CAVE_BIOMES):
            gens = fd.CAVE_DECORATOR_GENS.get(b, [])
            if not gens:
                continue
            is_b = draws_layer[:, li] & (cbb[:, li] == b)
            run_b = torch.zeros_like(r_surface)
            run_t = torch.zeros_like(r_surface)
            for gen in gens:
                if gen[5]:
                    run_t = run_t + gen[1]
                    blocks = _try_place(blocks, is_b & (r_top[:, li] < run_t), ceil_y, gen)
                else:
                    run_b = run_b + gen[1]
                    blocks = _try_place(blocks, is_b & (r_bottom[:, li] < run_b), floor_y, gen)

    return blocks.reshape(B, 16, 16, Y_SIZE)


def place_decorators_batch(blocks, heightfield, biome_weights, cave_starts, cave_ends,
                           cave_bottom_biome, chunk_pos):
    """Stage 6 for [B] chunks: K8 on CUDA, the plain version on the CPU."""
    args = (blocks, heightfield, biome_weights, cave_starts, cave_ends, cave_bottom_biome,
            chunk_pos)
    return place_decorators_batch_plain(*args)

