"""K7a's contract on the CPU: the streams of the VALID list entries, and the culls that read them.

The stream pre-kernel (``csrc/features.cu`` ``feature_streams_kernel``) writes the 64-draw
stream of each valid list entry only (slot < min(count, K) of each chunk and kind), a warp a
row, each draw by a jump from the entry's seed: draw j is ``lcg_value_at`` with the multiplier
a^(j+1) mod (2^31 - 1).  Here:
- a plain mirror of that design (the valid rows only, every draw from ``hashes.lcg_pow_table``'s
  65 entries, NaN elsewhere) equals ``features.draw_streams_plain`` on the valid rows and the JAX
  package's ``draw_stream`` (eager, exact mode) for the valid entries, on the K5 + K6 plain lists
  of a 3x3 area at chunk (-16, -16) and of one chunk past 2^24 blocks; the jump table is the one
  the kernel's header gets (``kernels/_build.py``);
- the plain culls of K7 and K7s (``features.cull_area_plain``, ``cull_slots_plain``) keep no entry
  at slot >= min(count, K) of its source, with and without the window cull: on those lists, and on
  synthetic lists whose every slot holds a feature and whose counts run past K (cave counts above
  1,024), where they keep exactly the visible entries below min(count, K).  That is what lets K7a
  skip every other row.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mega_minecraft_tpu.ops import hashes as jh
from mega_minecraft_tpu.terrain import features_sdf as j_sdf
from mega_minecraft_tpu_torch.kernels import _build
from mega_minecraft_tpu_torch.ops import hashes
from mega_minecraft_tpu_torch.terrain import caves, feature_placement as fp, features, heightfield, layers, pipeline
from mega_minecraft_tpu_torch.terrain import features_sdf as sdf
from mega_minecraft_tpu_torch.world import features_data as fd

#: the 3x3 area's first chunk (chunk coords), and a chunk past 2^24 blocks in x and -z
AREA = (-16, -16)
FAR = (1048580, -1048583)
KINDS = (("surface", fp.CHUNK_FEATURE_CAP, sdf.SEED_SURFACE_FEATURE_RNG),
         ("cave", fp.CHUNK_CAVE_FEATURE_CAP, sdf.SEED_CAVE_FEATURE_RNG))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lists(cx0, cz0, n):
    """K5 + K6 plain on the n x n area at chunk (cx0, cz0): its lists and chunk origins."""
    pos = pipeline.chunk_positions(cx0 - 1, cz0 - 1, n + 2, n + 2, device="cpu")
    st = layers.layers_from_halo_plain(*heightfield.generate_heightfield_plain(pos), pos, n, n)
    # chunk by chunk: the plain caves run faster on one chunk's tensors than on a batch's
    per = [caves.generate_caves_plain(st["heightfield"][i : i + 1], st["biome_weights"][i : i + 1],
                                      st["chunk_pos"][i : i + 1]) for i in range(n * n)]
    cv = {k: torch.cat([c[k] for c in per]) for k in per[0]}
    pl = fp.generate_placements_plain(st["heightfield"], st["biome_weights"], st["layers"], cv["starts"],
                                      cv["ends"], cv["bottom_biome"], cv["top_biome"], st["chunk_pos"])
    return fp.compact_placements_plain(pl, st["chunk_pos"]), st["chunk_pos"]


@pytest.fixture(scope="module")
def real_lists():
    """{"area": (lists, pos) of the 3x3 area, "far": (lists, pos) of the far chunk}."""
    return {"area": _lists(*AREA, 3), "far": _lists(*FAR, 1)}


def valid_rows(lists, K):
    """[B, K] bool: slot < min(count, K)."""
    return torch.arange(K)[None, :] < torch.clamp(lists["count"], max=K)[:, None]


def streams_valid_mirror(surface_lists, cave_lists):
    """K7a's design in plain torch: each valid entry's 64 draws by jumps from its seed_4 state
    (``lcg_value_at`` on a 65-entry power table); every other row NaN."""
    table = torch.as_tensor(hashes.lcg_pow_table(sdf.STREAM_LEN + 1))
    j = torch.arange(sdf.STREAM_LEN)
    out = []
    for lists, (_, K, seed) in zip((surface_lists, cave_lists), KINDS):
        valid = valid_rows(lists, K)
        rows = torch.full((valid.shape[0], K, sdf.STREAM_LEN), float("nan"))
        state0 = hashes.seed_4(lists["x"][valid], lists["y"][valid], lists["z"][valid], seed)
        rows[valid] = hashes.lcg_value_at(state0[:, None], j[None, :], table)
        out.append(rows)
    return out


def test_jump_table_is_the_kernels():
    """The kernel's __constant__ LCG_JUMP is a^(j+1) mod m for j < 64, the mirror's table."""
    line = next(l for l in _build.feature_tables_header().splitlines() if " LCG_JUMP[" in l)
    assert line.startswith("static __constant__ uint32_t LCG_JUMP[64] = {")
    vals = [int(v.strip().rstrip("u")) for v in line.split("{")[1].split("}")[0].split(",")]
    want = hashes.lcg_pow_table(65)[1:]
    assert vals == want.tolist() and want[0] == 48271
    v, s = 48271, []
    for _ in range(64):  # and stepping the multiplier by hand
        s.append(v)
        v = v * 48271 % (2**31 - 1)
    assert vals == s


def test_mirror_equals_plain_streams_and_jax_on_the_valid_rows(real_lists):
    """On the area's and the far chunk's lists, both kinds; JAX's draw_stream once on all the
    valid entries (each with its kind's seed)."""
    far_pos = real_lists["far"][1]
    assert int(far_pos[:, 0].min()) > 2**24 and int(far_pos[:, 1].max()) < -(2**24)
    got, ref_in = [], {c: [] for c in "xyzw"}
    for where in ("area", "far"):
        lists = real_lists[where][0]
        mirror = streams_valid_mirror(lists["surface"], lists["cave"])
        plain = features.draw_streams_plain(lists["surface"], lists["cave"])
        for (kind, K, seed), m, want in zip(KINDS, mirror, plain):
            valid = valid_rows(lists[kind], K)
            assert torch.equal(m[valid].view(torch.int32), want[valid].view(torch.int32)), (where, kind)
            assert bool(torch.isnan(m[~valid]).all()), (where, kind)
            got.append(m[valid])
            for c in "xyz":
                ref_in[c].append(lists[kind][c][valid])
            ref_in["w"].append(torch.full((int(valid.sum()),), seed, dtype=torch.int32))
        assert int(valid_rows(lists["surface"], fp.CHUNK_FEATURE_CAP).sum()) > 0, where
    ref_in = {c: jnp.asarray(torch.cat(v).numpy()) for c, v in ref_in.items()}
    assert ref_in["x"].shape[0] > 60, "vacuous"
    with jax.disable_jit(), jh.exact_scope(True):
        ref = np.asarray(j_sdf.draw_stream(ref_in["x"], ref_in["y"], ref_in["z"], ref_in["w"]))
    np.testing.assert_array_equal(torch.cat(got).numpy(), ref)


def _culled_slots(culled, K):
    """[N] (source row, slot) of every entry of a culled list ([B, cap, 8], lengths [B])."""
    lists, lengths = culled
    e = torch.cat([lists[b, : int(lengths[b]), 3] for b in range(lists.shape[0])]).long()
    return e // K, e % K


def _assert_cull_reads_valid_rows(count, K, culled):
    src, slot = _culled_slots(culled, K)
    assert bool((slot < torch.clamp(count.long()[src], max=K)).all())
    return int(src.numel())


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "no-cull"])
def test_culls_of_the_real_lists_keep_only_valid_slots(real_lists, cull):
    lists, pos = real_lists["area"]
    n = 0
    for kind, K, _ in KINDS:
        n += _assert_cull_reads_valid_rows(
            lists[kind]["count"], K, features.cull_area_plain(lists[kind], pos, 3, 3, kind == "cave", cull))
        table = {k: torch.cat([v, torch.zeros((1, *v.shape[1:]), dtype=v.dtype)]) for k, v in lists[kind].items()}
        nslots = torch.full((9, len(fp.GATHER_OFFSETS)), 9, dtype=torch.int32)
        for cb in range(9):
            vz, vx = divmod(cb, 3)
            for r, (dx, dz) in enumerate(fp.GATHER_OFFSETS):
                if 0 <= vx + dx < 3 and 0 <= vz + dz < 3:
                    nslots[cb, r] = (vz + dz) * 3 + vx + dx
        n += _assert_cull_reads_valid_rows(
            table["count"], K, features.cull_slots_plain(table, nslots, pos, kind == "cave", cull))
    assert n > 100, "vacuous"


def _dense_lists(seed):
    """A 3x3 area's lists whose every slot holds a feature (valid or not), counts 0..K + 500 (so
    past K too), positions near their chunk."""
    g = torch.Generator().manual_seed(seed)
    pos = pipeline.chunk_positions(0, 0, 3, 3, device="cpu")
    out = {}
    for kind, K, _ in KINDS:
        n_types = fd.NUM_CAVE_FEATURES if kind == "cave" else fd.NUM_FEATURES
        d = {"feature": torch.randint(1, n_types, (9, K), generator=g, dtype=torch.int32),
             "y": torch.randint(10, 300, (9, K), generator=g, dtype=torch.int32),
             "replace": torch.randint(0, 2, (9, K), generator=g, dtype=torch.int32)}
        d["x"] = pos[:, :1] + torch.randint(0, 16, (9, K), generator=g, dtype=torch.int32)
        d["z"] = pos[:, 1:] + torch.randint(0, 16, (9, K), generator=g, dtype=torch.int32)
        if kind == "cave":
            d["height"] = torch.randint(1, 40, (9, K), generator=g, dtype=torch.int32)
        d["count"] = torch.tensor([0, 3, K - 1, K, K + 500, 1, 40, K + 1, 17], dtype=torch.int32)
        out[kind] = d
    return out, pos


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "no-cull"])
def test_culls_of_overfull_lists_keep_exactly_the_valid_visible_slots(cull):
    lists, pos = _dense_lists(10)
    assert int(lists["cave"]["count"].max()) > fp.CHUNK_CAVE_FEATURE_CAP
    for kind, K, _ in KINDS:
        count = lists[kind]["count"]
        cap = fp.MAX_GATHERED_CAVE_FEATURES if kind == "cave" else fp.MAX_GATHERED_FEATURES
        culled = features.cull_area_plain(lists[kind], pos, 3, 3, kind == "cave", cull)
        _assert_cull_reads_valid_rows(count, K, culled)
        if not cull:  # every visible entry: the gathered valid slots, cut at the gather cap
            gathered = features.gather_prefix(count.numpy(), 3, 3)
            for b in range(9):
                vz, vx = divmod(b, 3)
                want = []
                for r, (dx, dz) in enumerate(fp.GATHER_OFFSETS):
                    if 0 <= vx + dx < 3 and 0 <= vz + dz < 3:
                        src = (vz + dz) * 3 + vx + dx
                        n = max(min(int(count[src]), K, cap - int(gathered[b, r])), 0)
                        want += [src * K + k for k in range(n)]
                got = culled[0][b, : int(culled[1][b]), 3].tolist()
                assert got == want, (kind, b)
