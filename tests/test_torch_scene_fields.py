"""The design of K10 / K10u (``csrc/brickmap.cu``) held on the CPU: its decomposition
emulated in numpy, word for word, against the plain versions; and K10u's macro rule over a
chain of streamed updates, whose end is held to the JAX package's own chain.

The kernels keep four u8 channels a voxel (the 3-D distance and the up, slab-2 and slab-8
clearances), interleaved by 4-voxel words of a column: a doubling round takes each
channel's min over its in-volume neighbours (the 3-D distance over {-s, 0, s}^3, its y
neighbours a funnel shift of the next word for s < 4 or the word s/4 away; a clearance over
{-s, 0, s}^2 of the same y), a neighbour outside the volume counting as the cap.  A round's
CTA takes a tile of one class of columns (z mod s, x mod s) and the columns around it, one
class step away, in three separable passes (y, x, z).  The emulation below takes the same
steps on the same words (the prep's column tops and 12-bit solid windows, the rounds' tiles
in the kernel's order, every output word written once, the encoding that folds in the last
round and reads solidity from the distance) and must give
``chebyshev_distance`` / ``_clearance_bits`` / ``build_fields_plain`` /
``update_chunks_plain`` exactly, on dims that are multiples of 4 and not of 16 in z or x,
with solids on every face of the volume, unseeded and seeded as K10u seeds.

K10u takes a macro cell's solidity from its old macro word outside the updated region (low
byte 0: solid) and from the region's blocks inside it; this holds exactly while a scene's
macro level is the one computed from its fine level, which every writer of a scene keeps.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mega_minecraft_tpu.app.engine import _assemble_region as jax_assemble_region
from mega_minecraft_tpu.render import brickmap as jb
from mega_minecraft_tpu.world.blocks import RENDER_SOLID, Block as B
from mega_minecraft_tpu_torch.render import brickmap as tb

CAP = tb.DIST_CAP
CAP4 = np.uint32(CAP * 0x01010101)
EMPTY = tb.EMPTY_BASE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the kernels' steps in numpy -----------------------------------------------------------


def vmin(a, b):
    """The kernels' byte-wise min of two u32 arrays whose bytes are below 128: a SWAR
    compare (a + 0x80 - b stays in its byte), held here to numpy's byte min."""
    a, b = np.broadcast_arrays(np.asarray(a, np.uint32), np.asarray(b, np.uint32))
    assert not ((a | b) & 0x80808080).any(), "a state byte reached 128"
    g = ((a.astype(np.uint64) + 0x80808080 - b) & 0x80808080).astype(np.uint32)
    m = g - (g >> np.uint32(7))
    r = (b & m) | (a & ~m)
    assert (r.view(np.uint8) == np.minimum(np.ascontiguousarray(a).view(np.uint8),
                                           np.ascontiguousarray(b).view(np.uint8))).all()
    return r


def funnel_l(lo, hi, sh):
    """__funnelshift_l(lo, hi, sh): the high word of (hi:lo) << sh."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v << np.uint64(sh)) >> np.uint64(32)).astype(np.uint32)


def funnel_r(lo, hi, sh):
    """__funnelshift_r(lo, hi, sh): the low word of (hi:lo) >> sh."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (v >> np.uint64(sh)).astype(np.uint32)


def pack(bytes_):
    """[..., Y] u8 -> [..., Y / 4] u32 words (byte j of word w: y = 4w + j)."""
    return np.ascontiguousarray(bytes_.astype(np.uint8)).view(np.uint32)


def unpack(words):
    return np.ascontiguousarray(words).view(np.uint8)


def bits4(b):
    return (b | b >> 7 | b >> 14 | b >> 21) & 0xF


def prep(solid, seeds=None):
    """The prep kernels' seeds of a level: solid [Z, X, Y] bool, seeds (the old bounds of the
    four channels, [Z, X, Y] each, or the cap) -> (state [Z, X, W, 4] u32, top [Z, X])."""
    Z, X, Y = solid.shape
    W = Y // 4
    sol = pack(solid)
    top = np.where(solid.any(2), Y - 1 - np.argmax(solid[:, :, ::-1], axis=2), -1)
    colw = np.concatenate([np.zeros((Z, X, 2), np.uint32), sol], axis=2)  # y = -8..-1 air
    m12 = bits4(colw[..., :W]) | bits4(colw[..., 1:W + 1]) << 4 | bits4(colw[..., 2:]) << 8
    if seeds is None:
        seeds = [np.full((Z, X, Y), CAP, np.uint8)] * 4
    seed_w = [pack(np.minimum(s, CAP)) for s in seeds]
    state = np.zeros((Z, X, W, 4), np.uint32)
    y0 = 4 * np.arange(W)
    for j in range(4):
        sh = np.uint32(8 * j)
        keep = [((m12 >> (8 + j)) & 1) == 0, (y0 + j)[None, None, :] > top[:, :, None],
                ((m12 >> (6 + j)) & 7) == 0, ((m12 >> j) & 0x1FF) == 0]
        for ch in range(4):
            state[..., ch] |= np.where(keep[ch], (seed_w[ch] >> sh) & 0xFF, 0).astype(np.uint32) << sh
    return state, top


TK, TW = 6, 8  # the round kernels' tile: output columns a side, words of y


def cdiv(a, b):
    return -(-a // b)


def stage_y(state, s):
    """Every word with its channel 0 reduced over y - s, y, y + s (the cap outside the
    column), as the staging pass leaves it in shared memory."""
    ch0 = state[..., 0]
    Z, X, W = ch0.shape
    k = s // 4
    cap = np.full((Z, X, max(k, 1)), CAP4, np.uint32)
    if s < 4:
        prev = np.concatenate([cap[..., :1], ch0[..., :-1]], axis=2)
        nxt = np.concatenate([ch0[..., 1:], cap[..., :1]], axis=2)
        lo, hi = funnel_l(prev, ch0, 8 * s), funnel_r(ch0, nxt, 8 * s)
    elif k >= W:
        lo = hi = np.full_like(ch0, CAP4)
    else:
        lo = np.concatenate([cap[..., :k], ch0[..., :-k]], axis=2)
        hi = np.concatenate([ch0[..., k:], cap[..., :k]], axis=2)
    out = state.copy()
    out[..., 0] = vmin(ch0, vmin(lo, hi))
    return out


def tile_words(Z, X, W, s):
    """The output words of every CTA of a round, in the kernel's order: [blocks, TK, TK, TW]
    (z, x, w) and whether each lies in the level."""
    Cz, Cx = min(s, Z), min(s, X)
    tz, tx, tw = cdiv(cdiv(Z, s), TK), cdiv(cdiv(X, s), TK), cdiv(W, TW)
    b = np.arange(Cz * Cx * tz * tx * tw)
    iw, r = b % tw, b // tw
    ix, r = r % tx, r // tx
    iz, r = r % tz, r // tz
    cx, cz = r % Cx, r // Cx
    k = np.arange(TK)
    z = (cz + s * iz * TK)[:, None, None, None] + s * k[None, :, None, None]
    x = (cx + s * ix * TK)[:, None, None, None] + s * k[None, None, :, None]
    w = (iw * TW)[:, None, None, None] + np.arange(TW)[None, None, None, :]
    z, x, w = np.broadcast_arrays(z, x, w)
    return z, x, w, (z < Z) & (x < X) & (w < W)


def round_(state, s):
    """One launch of scene_round_kernel on a level.  Its CTAs (TK x TK tiles of one class of
    columns, z mod s and x mod s, and TW words) write every output word exactly once; each
    stages the columns one class step around its tile (the cap outside the level) and takes
    the min over x - s, x, x + s of each staged row, then over z - s, z, z + s, plus s,
    against the word's own value: the same passes here over the whole level at once."""
    Z, X, W, _ = state.shape
    z, x, w, ok = tile_words(Z, X, W, s)
    written = np.zeros((Z, X, W), np.int32)
    np.add.at(written, (z[ok], x[ok], w[ok]), 1)
    assert (written == 1).all(), f"round {s}: words written {np.unique(written)} times"
    ys = np.pad(stage_y(state, s), ((s, s), (s, s), (0, 0), (0, 0)), constant_values=CAP4)
    rows = vmin(vmin(ys[:, :X], ys[:, s:s + X]), ys[:, 2 * s:2 * s + X])
    m = vmin(vmin(rows[:Z], rows[s:s + Z]), rows[2 * s:2 * s + Z])
    return vmin(state, m + np.uint32(s * 0x01010101))


def sky_of(top):
    Z, X = top.shape
    p = np.pad(top, tb.SKY_R, constant_values=-1)
    return np.max([p[dz:dz + Z, dx:dx + X] for dz in range(2 * tb.SKY_R + 1)
                   for dx in range(2 * tb.SKY_R + 1)], axis=0)


def sweep(state, top):
    """Rounds 1-16 and the encoding's round 32: the four channels [Z, X, Y] u8 each, and the
    skyline of the tops."""
    for s in (1, 2, 4, 8, 16, 32):
        state = round_(state, s)
    Z, X, W, _ = state.shape
    return [unpack(state[..., ch]).reshape(Z, X, 4 * W) for ch in range(4)], sky_of(top)


def encode(chans, sky, low, solid, q_seed=None, macro=False):
    """scene_encode_kernel's words of a level (i32): a voxel is solid where its distance is
    0, which must be exactly the prep's solid voxels."""
    d, up, c2, c8 = (c.astype(np.int64) for c in chans)
    np.testing.assert_array_equal(d == 0, solid)
    Y = d.shape[2]
    q = np.minimum(np.clip(np.arange(Y)[None, None, :] - sky[:, :, None], 0, 124) >> 2,
                   31 if q_seed is None else q_seed)
    low_out = np.where(solid, 0 if macro else low, EMPTY - 1 + np.maximum(d, 1)).astype(np.int64)
    word = low_out | up << 8 | c2 << 14 | c8 << 20 | q.astype(np.int64) << 26
    if not macro:
        ids = np.where(solid, low, 0)
        flag = solid & tb.ALPHA_TESTED[ids]
        word |= np.where(flag, (1 << 31) | (tb.ALPHA_T_FRAC[ids].astype(np.int64) << 8), 0)
    return word.astype(np.uint32).view(np.int32)


def emulate_scene_fields(vol):
    """K10 on a [Z, X, Y] u8 volume: the fine level, then the macro level seeded from the
    prep CTAs' any-solid cells."""
    solid = RENDER_SOLID[vol]
    fine = encode(*sweep(*prep(solid)), vol, solid)
    Z, X, Y = vol.shape
    msolid = solid.reshape(Z // 4, 4, X // 4, 4, Y // 4, 4).any(axis=(1, 3, 5))
    macro = encode(*sweep(*prep(msolid)), None, msolid, macro=True)
    return np.concatenate([fine.reshape(-1), macro.reshape(-1)])


def region_of(d_blocks, slots, mask, gz, gx):
    """The region's blocks [gz*16, gx*16, Y] from the slot table (air where masked)."""
    ch = np.where(np.asarray(mask)[:, None, None, None], d_blocks[np.asarray(slots)], 0)
    return ch.reshape(gz, gx, 16, 16, -1).transpose(0, 2, 1, 3, 4).reshape(gz * 16, gx * 16, -1)


def macro_solid_by_rule(old_macro, region, z0, x0):
    """K10u's macro solidity: the old macro words' (low byte 0) outside the region, the
    region's blocks' any-solid inside it."""
    msolid = (old_macro & 0xFF) == 0
    dz, dx, Y = region.shape
    rs = RENDER_SOLID[region].reshape(dz // 4, 4, dx // 4, 4, Y // 4, 4).any(axis=(1, 3, 5))
    msolid[z0 // 4:(z0 + dz) // 4, x0 // 4:(x0 + dx) // 4] = rs
    return msolid


def emulate_update_chunks(flat, dims, d_blocks, slots, mask, gz, gx, z0, x0):
    """K10u on a scene's flat words: the window seeded from the old words (the region's
    blocks and the cap inside it), the macro level from the rule."""
    Z, X, Y = dims
    n = Z * X * Y
    field, old_macro = flat[:n].reshape(Z, X, Y), flat[n:].reshape(Z // 4, X // 4, Y // 4)
    zlo, xlo, wz, wx = tb.update_window(dims, gz, gx, z0, x0)
    old = field[zlo:zlo + wz, xlo:xlo + wx].astype(np.int64) & 0xFFFFFFFF
    low = (old & 0xFF).astype(np.int64)
    seeds = [np.minimum(np.maximum(low - (EMPTY - 1), 1), CAP), (old >> 8) & 0x3F, (old >> 14) & 0x3F,
             (old >> 20) & 0x3F]
    q_seed = (old >> 26) & 0x1F
    region = region_of(d_blocks, slots, mask, gz, gx)
    rz, rx, dz, dx = z0 - zlo, x0 - xlo, gz * 16, gx * 16
    rsolid = RENDER_SOLID[region]
    low[rz:rz + dz, rx:rx + dx] = np.where(rsolid, region, EMPTY)
    for s in seeds:
        s[rz:rz + dz, rx:rx + dx] = CAP
    q_seed[rz:rz + dz, rx:rx + dx] = 31
    solid = (low > 0) & (low < EMPTY)
    words = encode(*sweep(*prep(solid, [s.astype(np.uint8) for s in seeds])), low, solid, q_seed)
    out = flat.copy()
    out[:n].reshape(Z, X, Y)[zlo:zlo + wz, xlo:xlo + wx] = words
    msolid = macro_solid_by_rule(old_macro, region, z0, x0)
    out[n:] = encode(*sweep(*prep(msolid)), None, msolid, macro=True).reshape(-1)
    return out


# -- volumes -------------------------------------------------------------------------------


def terrain_volume(seed: int, Z: int, X: int, Y: int = 384) -> np.ndarray:
    """A seeded [Z, X, Y] u8 volume with the shapes of a featured area: rough stone and dirt
    terrain under grass, a water pool, a cave, tree trunks with leaf canopies, X-shaped flora,
    glowstone, a floating island; solids on every face of the volume."""
    rng = np.random.RandomState(seed)
    vol = np.zeros((Z, X, Y), np.uint8)
    base = Y // 4
    zz, xx = np.meshgrid(np.arange(Z), np.arange(X), indexing="ij")
    hts = (base + 8 * np.sin(zz / 7.0 + seed) + 6 * np.cos(xx / 5.0) + rng.randint(0, 3, (Z, X))).astype(int)
    y = np.arange(Y)[None, None, :]
    vol[y < hts[..., None] - 3] = int(B.STONE)
    vol[(y >= hts[..., None] - 3) & (y < hts[..., None])] = int(B.DIRT)
    vol[zz, xx, hts] = int(B.GRASS_BLOCK)
    vol[Z // 4:Z // 2, X // 4:X // 2, base - 4:base + 2] = int(B.WATER)
    vol[2:Z - 2, X // 3:X // 3 + 3, base - 20:base - 15] = 0  # a cave
    for _ in range(max(2, Z * X // 200)):
        tz, tx = rng.randint(2, Z - 2), rng.randint(2, X - 2)
        h = hts[tz, tx]
        vol[max(0, tz - 2):tz + 3, max(0, tx - 2):tx + 3, h + 4:h + 8] = int(B.BIRCH_LEAVES)
        vol[tz, tx, h + 1:h + 6] = int(B.BIRCH_WOOD)
    for _ in range(Z * X // 20):
        tz, tx = rng.randint(0, Z), rng.randint(0, X)
        vol[tz, tx, hts[tz, tx] + 1] = int(B.POPPY if rng.rand() < 0.5 else B.GRASS)
    vol[Z // 2, X // 2 - 2:X // 2 + 2, base + 3] = int(B.GLOWSTONE)
    vol[1:4, 1:5, Y - 40:Y - 36] = int(B.STONE)
    vol[:, :, Y - 1][rng.rand(Z, X) < 0.01] = int(B.STONE)  # the top face
    vol[0, :, base + 30] = vol[-1, :, base + 31] = int(B.STONE)  # the z faces above ground
    vol[:, 0, base + 50] = vol[:, -1, base + 20] = int(B.BIRCH_LEAVES)  # the x faces
    return vol


def random_mask(seed: int, Z=36, X=20, Y=384, p=5e-5):
    """A sparse seeded mask with solids on the volume's six faces."""
    rng = np.random.RandomState(seed)
    m = rng.rand(Z, X, Y) < p
    m[0, 3, 200] = m[Z - 1, 5, 17] = m[7, 0, 301] = m[11, X - 1, 90] = True
    m[4, 9, 0] = m[20, 13, Y - 1] = True
    m[:, :, :30] |= rng.rand(Z, X, 30) < 0.5  # a rough floor
    return m


def k10u_seeds(seed: int, Z=36, X=20, Y=384):
    """Seeds as K10u's window takes them: the bounds of an older scene's words, the cap in
    a region."""
    old = tb.build_fields_plain(torch.from_numpy(terrain_volume(seed, Z, X, Y)))[:Z * X * Y]
    old = old.numpy().reshape(Z, X, Y).astype(np.int64) & 0xFFFFFFFF
    seeds = [np.maximum((old & 0xFF) - (EMPTY - 1), 1), (old >> 8) & 0x3F, (old >> 14) & 0x3F,
             (old >> 20) & 0x3F, (old >> 26) & 0x1F]
    for s in seeds:
        s[8:24, 4:20] = 31 if s is seeds[4] else CAP
    return [np.minimum(s, CAP).astype(np.int32) for s in seeds]


# -- (b) the decomposition against the plain versions ---------------------------------------


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "k10u_seeds"])
def test_decomposition_equals_distance_and_clearances(seeded):
    solid = random_mask(1 + seeded)
    seeds = k10u_seeds(5) if seeded else None
    state, top = prep(solid, None if seeds is None else [s.astype(np.uint8) for s in seeds[:4]])
    (d, up, c2, c8), sky = sweep(state, top)
    t = torch.from_numpy(solid)
    init = [None] * 5 if seeds is None else [torch.from_numpy(s) for s in seeds]
    np.testing.assert_array_equal(d, tb.chebyshev_distance(t, init=init[0]).numpy())
    np.testing.assert_array_equal(up, tb._up_clearance(t, init=init[1]).numpy())
    np.testing.assert_array_equal(c2, tb._slab_clearance(t, 2, init=init[2]).numpy())
    np.testing.assert_array_equal(c8, tb._slab_clearance(t, 8, init=init[3]).numpy())
    q = np.minimum(np.clip(np.arange(384)[None, None, :] - sky[:, :, None], 0, 124) >> 2,
                   31 if seeds is None else seeds[4])
    np.testing.assert_array_equal(q, tb._skyline_descent(t, init=init[4]).numpy())
    # the transform did work in every channel, with the faces' solids
    assert (d == 0).sum() == solid.sum() and d.max() >= 32 and (d > 16).sum() > 10000
    assert (up > 0).sum() > 1000 and (c8 < CAP).sum() > 1000


def test_emulated_k10_equals_build_fields_plain():
    vol = terrain_volume(3, 36, 20)
    want = tb.build_fields_plain(torch.from_numpy(vol)).numpy()
    np.testing.assert_array_equal(emulate_scene_fields(vol), want)


def test_emulated_k10u_equals_update_chunks_plain():
    """A 1x9-chunk scene (the window narrower than it in x), one chunk rewritten in its
    middle and one removed at its edge (clamped window), each from the scene before."""
    vol = terrain_volume(4, 16, 144)
    flat = tb.build_fields_plain(torch.from_numpy(vol)).numpy()
    dims = vol.shape
    d_blocks = np.ascontiguousarray(terrain_volume(9, 32, 32).reshape(2, 16, 2, 16, 384)
                                    .transpose(0, 2, 1, 3, 4).reshape(4, 16, 16, 384))
    for gz, gx, z0, x0, slots, mask in ((1, 1, 0, 64, [2], [True]), (1, 1, 0, 128, [0], [False])):
        zlo, xlo, wz, wx = tb.update_window(dims, gz, gx, z0, x0)
        assert wx < dims[1] and (xlo > 0 or x0 == 128)
        scene = tb.Scene(torch.from_numpy(flat.copy()), (0, 0, 0), dims)
        want = tb.update_chunks_plain(scene, torch.from_numpy(d_blocks), slots, mask, gz, gx, z0, x0).numpy()
        got = emulate_update_chunks(flat, dims, d_blocks, slots, mask, gz, gx, z0, x0)
        np.testing.assert_array_equal(got, want)
        assert (want != flat).sum() > 1000
        flat = want


# -- (a) K10u's macro rule over a chain of updates -------------------------------------------


def test_macro_rule_over_a_chain_of_updates_and_jax_chain():
    """A 4x4-chunk scene, then a rewrite, a removal to air and a corner bucket (every
    window clamped to the scene): after each update the macro solidity from the old macro
    words plus the region equals ``_encode_macro``'s from the new fine field, so the macro
    words do; the chain's end equals the JAX package's chain."""
    vol = terrain_volume(6, 64, 64)
    chunks = vol.reshape(4, 16, 4, 16, 384).transpose(0, 2, 1, 3, 4)
    scene = tb.build_scene(torch.from_numpy(np.ascontiguousarray(chunks)), 0, 0, device="cpu")
    jscene = jb.build_scene(jnp.asarray(chunks), 0, 0)
    np.testing.assert_array_equal(scene.flat.numpy(), np.asarray(jscene.flat))
    d_blocks = np.ascontiguousarray(terrain_volume(8, 32, 32).reshape(2, 16, 2, 16, 384)
                                    .transpose(0, 2, 1, 3, 4).reshape(4, 16, 16, 384))
    n = 64 * 64 * 384
    chain = (("rewrite", 2, 2, 16, 16, [3, 2, 1, 0], [True] * 4),
             ("removal to air", 2, 2, 0, 32, [0, 1, 2, 3], [False] * 4),
             ("corner bucket", 1, 1, 48, 48, [1], [True]))
    for tag, gz, gx, z0, x0, slots, mask in chain:
        old_macro = scene.flat[n:].numpy().reshape(16, 16, 96).copy()
        new = tb.update_chunks_plain(scene, torch.from_numpy(d_blocks), slots, mask, gz, gx, z0, x0)
        region = region_of(d_blocks, slots, mask, gz, gx)
        rule = macro_solid_by_rule(old_macro, region, z0, x0)
        field = new[:n].view(64, 64, 384)
        low = field & 0xFF
        fine_rule = ((low > 0) & (low < EMPTY)).view(16, 4, 16, 4, 96, 4).any(5).any(3).any(1).numpy()
        np.testing.assert_array_equal(rule, fine_rule, err_msg=tag)
        assert (rule != ((old_macro & 0xFF) == 0)).any(), tag  # the update moved macro solidity
        # the macro words the kernel makes from the rule are the plain version's
        macro = encode(*sweep(*prep(rule)), None, rule, macro=True)
        np.testing.assert_array_equal(macro.reshape(-1), new[n:].numpy(), err_msg=tag)
        scene.flat.copy_(new)
        jregion = jax_assemble_region(jnp.asarray(d_blocks), jnp.asarray(slots, jnp.int32), jnp.asarray(mask),
                                      gz, gx)
        jscene = jb.update_chunks(jscene, jregion, z0, x0)
    np.testing.assert_array_equal(scene.flat.numpy(), np.asarray(jscene.flat))
