"""The traffic is a function of ``--seed``: the same seed draws the same inputs and check
samples, another seed others; and the end-to-end metrics take all the work over all the
time of the window (a rate) or all its frames (a tail)."""

from __future__ import annotations

import itertools
import math
import time
import types

import numpy as np
import pytest
import torch

from mmbench import spec, tracing
from mmbench.traffic import flyloop, pregen

CPU = torch.device("cpu")
BIG = 2 ** 31 + 5  # seeds may pass 32 signed bits


def _pregen(seed, seconds=20.0):
    cell = spec.cell("pregen33_featured")
    return pregen.Workload(cell, spec.config(cell["config"]), seed, seconds, tracing.Spans(False), CPU)


def _fly(seed, name="flyloop_540up"):
    cell = spec.cell(name)
    return flyloop.Workload(cell, spec.config(cell["config"]), seed, 20.0, tracing.Spans(False), CPU)


@pytest.mark.parametrize("seed", [0, BIG, 2 ** 40 + 3])
def test_pregen_origins_follow_the_seed(seed):
    a, b = _pregen(seed), _pregen(seed)
    oa, ob = (w.pool()[list(itertools.islice(w.pool_order(), 500))] for w in (a, b))
    np.testing.assert_array_equal(oa, ob)
    lo, hi = spec.cell("pregen33_featured")["traffic"]["origin_range"]
    assert oa.min() >= lo and oa.max() < hi
    pool = {tuple(o) for o in a.pool()}
    assert len(pool) == a.pool_areas, "the pool repeats an origin"
    # each pass over the pool holds every origin once, in an order of the seed's
    n = a.pool_areas
    for k in range(500 // n):
        assert {tuple(o) for o in oa[k * n:(k + 1) * n]} == pool
    assert not np.array_equal(oa[:n], oa[n:2 * n])
    c = _pregen(seed + 1)
    oc = c.pool()[list(itertools.islice(c.pool_order(), 500))]
    assert not np.array_equal(oa, oc) and {tuple(o) for o in oc[:n]} == pool
    pa, pb = a._pos_halo(oa[:3]), b._pos_halo(ob[:3])
    assert torch.equal(pa, pb) and pa.shape == (3, 35 * 35, 2)


@pytest.mark.parametrize("seed", [1, BIG])
def test_flight_follows_the_seed(seed):
    a, b, c = _fly(seed), _fly(seed), _fly(seed + 1)
    air = list(range(40, 400, 3))
    assert (a.phase, a.pick_frames(air)) == (b.phase, b.pick_frames(air))
    assert (a.phase, a.pick_frames(air)) != (c.phase, c.pick_frames(air))
    # the checked frames are distinct frames of the candidates, as many as the cell checks
    picked = _fly(seed).pick_frames(air)
    assert len(set(picked)) == a.n_frames and set(picked) <= set(air)
    assert _fly(seed).pick_frames(air[:2]) == tuple(air[:2])
    # every seed flies the same world from the same pose: only the window's start differs
    assert a.theta0 == c.theta0 and 0 <= a.phase < a.lap and a.path_chunks() == c.path_chunks()
    pos, theta, _ = a.start_pose()
    np.testing.assert_allclose(np.hypot(pos[0], pos[2]), a.radius, rtol=1e-6)
    # the flight closes its circle in one lap: the camera's moves bring it back
    from mmbench.reference.frame import Flight

    f = Flight(*a.start_pose())
    for _ in range(a.lap):
        f.step((0.0, 0.0, a.step), (a.turn, 0.0))
    assert np.hypot(*(f.player.pos - pos)[[0, 2]]) < a.step
    assert a.lap == round(2 * math.pi * a.radius / a.step)


def test_the_rate_is_all_the_work_over_all_the_time():
    wl = _pregen(3)
    wl.completed, wl.window_s = 7, 2.0
    assert wl.end_to_end() == {"gen_chunks_per_s": (7 * 33 * 33 / 2.0, "chunks/s")}


def test_the_pregen_window_ends_with_its_last_area():
    """Past the deadline nothing more is issued; every issued area is waited for and counts,
    and the window's time runs to the last one's end."""
    wl = _pregen(5, seconds=0.2)
    ends = []

    def gen(pos, nx, nz, features):
        time.sleep(0.03)
        ends.append(time.perf_counter())
        rows = torch.zeros((nx * nz, 1), dtype=torch.uint8)
        return {"blocks": rows, "heightfield": rows.float(), "biome_weights": rows.float(),
                "layers": rows.float()}

    wl.pipeline = types.SimpleNamespace(generate_area_fused=gen)
    wl.origins = wl.pool()
    wl.pool_pos = torch.zeros((wl.pool_areas, 1, 2), dtype=torch.int32)
    t0 = time.perf_counter()
    wl.window()
    assert wl.completed == wl.issued == len(ends) >= 2
    assert wl.window_s >= 0.2 and t0 + wl.window_s >= ends[-1]
    assert wl.end_to_end()["gen_chunks_per_s"][0] == wl.issued * 33 * 33 / wl.window_s


def test_the_tail_is_the_percentile_of_every_frame():
    wl = _fly(3)
    frames = [0.002] * 90 + [0.010] * 9 + [0.5]
    wl.frame_s, wl.window_s = frames, sum(frames)
    e2e = wl.end_to_end()
    assert e2e["frame_ms"] == (sum(frames) / 100 * 1e3, "ms")
    assert e2e["frame_ms_p95"] == (float(np.percentile(frames, 95)) * 1e3, "ms")
    assert e2e["frame_ms_p95"][0] == pytest.approx(10.0)
