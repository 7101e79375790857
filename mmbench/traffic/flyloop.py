"""A player flying a circle around an explored area, every frame presented.

Set-up builds the engine (``app/engine.py``) at the configuration's settings, puts the
camera on a circle of ``radius_blocks`` around ``center`` at height ``y``, at the cell's
``start_angle``, facing along the circle, drains the generation radius around every chunk
the circle passes and uploads the scene, flies ``warmup_laps`` laps (every shape warm), drains
and uploads again, so that the window generates nothing, and flies on to the window's start,
a number of frames into the next lap drawn from the seed.  So every seed sees the same world
and scene, and its window starts at another point of the circle.  The flight turns
``step_blocks / radius_blocks`` radians a frame and moves ``step_blocks`` forward, with ``dt``
seconds a frame; the sun holds still when ``sun_paused``.  A frame is one ``Engine.tick`` and
one ``Engine.present``, which ends in the frame's copy to the host.  On a circle that keeps
the player within a few chunks of the scene window's centre, every chunk of the window stays
in the VBO radius and drawable, and the window's ticks run no scene update (K10u).

The check (``reference/frame.py``, ``reference/chunk.py``):
- ``frames`` frames of the window, drawn from the seed among those of ``frame_range`` whose
  camera is in air (a camera inside terrain sees one block's face): the plain reference
  follows each from the history buffers and the scene the engine rendered it with (both
  copied in the window), with the camera, sky and frame number worked out from the flight;
- the scene's fields after the window against fields built from the drawable chunks' blocks:
  every voxel's solidity and solid block equal, and no distance or clearance larger than the
  built field's (a streamed update may leave them smaller: they stay safe bounds);
- ``sites`` clusters of ``cluster`` x ``cluster`` drawable chunks, drawn from the seed: their
  blocks, and their sources' heightfields, biome weights and caves, regenerated from their
  coordinates and the slot table's eroded layers.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from ..reference import chunk as ref_chunk
from ..reference import frame as ref_frame
from ..reference.render.brickmap import EMPTY_BASE, MACRO_SCALE, SKY_R, Scene, _dilate_max_2d
from ..reference.world.blocks import Block
from . import sync

AIR = int(Block.AIR)

#: K11: pass 0 and the bounce passes of one sample
K11_KERNELS = {"render_sample_kernel": 1, "render_bounce_kernel": 6}


class Workload:
    def __init__(self, cell, config, seed: int, seconds: float, spans, device):
        self.cell, self.config, self.seconds, self.spans, self.device = cell, config, seconds, spans, device
        tr = cell["traffic"]
        self.radius = float(tr["radius_blocks"])
        self.step = float(tr["step_blocks"])
        self.dt = float(tr["dt"])
        self.y = float(tr["y"])
        self.pitch = float(tr["pitch"])
        self.center = tuple(float(v) for v in tr["center"])
        self.warmup_laps = int(tr["warmup_laps"])
        self.sun_time0 = float(tr["sun_time"])
        self.sun_paused = bool(tr["sun_paused"])
        self.turn = self.step / self.radius
        self.lap = int(round(2 * math.pi / self.turn))
        ck = cell["check"]
        self.limits = ck["limits"]
        self.n_frames, self.frame_range = int(ck["frames"]), tuple(ck["frame_range"])
        self.n_sites, self.k = int(ck["sites"]), int(ck["cluster"])
        self.theta0 = float(tr["start_angle"])
        rng = np.random.default_rng([seed, 0])
        self.phase = int(rng.integers(0, self.lap))
        self.frame_rng = np.random.default_rng([seed, 2])
        self.sample_rng = np.random.default_rng([seed, 1])
        self.check_frames = ()
        self.ticks = 0

    def _engine_config(self):
        from mega_minecraft_tpu_torch.app.engine import EngineConfig

        w, r = self.config["world"], self.config["render"]
        return EngineConfig(width=r["width"], height=r["height"], view_chunks=w["view_chunks"],
                            gen_radius=w["gen_radius"], capacity=w["capacity"],
                            skip_erosion=not w["erosion"], sun_time0=self.sun_time0,
                            use_denoising=r["denoising"], use_upscaling=r["upscaling"],
                            use_reprojection=r["reprojection"], device=str(self.device))

    def start_pose(self):
        """(pos, theta, phi): on the circle at the start angle, facing along it."""
        th = self.theta0
        x = self.center[0] - self.radius * math.cos(th)
        z = self.center[1] + self.radius * math.sin(th)
        return np.array([x, self.y, z], np.float32), th, self.pitch

    def path_chunks(self):
        """[(x, z)]: a block position in each chunk that one lap of the flight enters, in
        order."""
        flight = ref_frame.Flight(*self.start_pose())
        seen, out = set(), []
        for _ in range(self.lap):
            flight.step((0.0, 0.0, self.step), (self.turn, 0.0))
            x, z = float(flight.player.pos[0]), float(flight.player.pos[2])
            c = (math.floor(x / 16.0), math.floor(z / 16.0))
            if c not in seen:
                seen.add(c)
                out.append((x, z))
        return out

    def _frame(self):
        self.eng.tick(self.dt, move=(0.0, 0.0, self.step), rotate=(self.turn, 0.0))
        self.ticks += 1

    def setup(self):
        from mega_minecraft_tpu_torch.app.engine import Engine

        self.eng = eng = Engine(self._engine_config())
        eng.time_paused = self.sun_paused
        pos, theta, phi = self.start_pose()
        eng.player.pos, eng.player.theta, eng.player.phi = pos.copy(), theta, phi
        # drain the generation radius around every chunk the circle passes, so that the
        # window's scheduler finds nothing to generate
        for x, z in self.path_chunks() + [(float(pos[0]), float(pos[2]))]:
            eng.scheduler.set_player_pos(x, z)
            eng.scheduler.drain()
        eng._upload_new_chunks()
        for _ in range(self.warmup_laps * self.lap):
            self._frame()
            eng.present()
        eng.scheduler.drain()
        eng._upload_new_chunks()
        for _ in range(self.phase):
            self._frame()
            eng.present()
        self.check_frames = self.pick_frames(self.air_frames())
        sync(self.device)

    def air_frames(self):
        """The frames of ``frame_range`` whose camera block is air in a drawable chunk."""
        lo, hi = self.frame_range
        drawable = {(cx, cz): s for cx, cz, s in self._drawable()}
        flight = ref_frame.Flight(*self.start_pose())
        for _ in range(self.ticks + lo):
            flight.step((0.0, 0.0, self.step), (self.turn, 0.0))
        frames, where = [], []
        for i in range(lo, hi):
            flight.step((0.0, 0.0, self.step), (self.turn, 0.0))
            x, y, z = (int(math.floor(float(v))) for v in flight.player.pos)
            c = (x // 16, z // 16)
            s = drawable.get(c)
            if s is not None and 0 <= y < 384:
                frames.append(i)
                where.append((s, z - 16 * c[1], x - 16 * c[0], y))
        if not frames:
            return []
        idx = torch.as_tensor(where, device=self.device).T
        air = (self.eng.scheduler.t.d_blocks[idx[0], idx[1], idx[2], idx[3]] == AIR).tolist()
        return [i for i, a in zip(frames, air) if a]

    def pick_frames(self, candidates):
        """``frames`` distinct frames of ``candidates``, drawn from the seed, in order."""
        pick = self.frame_rng.choice(len(candidates), size=min(self.n_frames, len(candidates)), replace=False)
        return tuple(sorted(candidates[int(j)] for j in pick))

    def window(self):
        eng, checked = self.eng, set(self.check_frames)
        self.frame_s = []
        self.snaps = {}
        t0 = time.perf_counter()
        deadline = t0 + self.seconds
        t = t0
        while t < deadline:
            i = len(self.frame_s)
            if i in checked:
                history = tuple(b.clone() for b in eng.fbs)
                ticks_before = self.ticks
            with self.spans.span("tick"):
                self._frame()
            if i in checked:
                scene = (eng.scene.flat.clone(), eng.scene.origin, eng.scene.dims)
            with self.spans.span("present"):
                img = eng.present()
            if i in checked:
                self.snaps[i] = {"history": history, "ticks_before": ticks_before, "scene": scene, "image": img}
            end = time.perf_counter()
            self.frame_s.append(end - t)
            t = end
        self.window_s = t - t0

    def end_to_end(self):
        n = len(self.frame_s)
        return {"frame_ms": (self.window_s / n * 1e3, "ms"),
                "frame_ms_p95": (float(np.percentile(np.asarray(self.frame_s), 95)) * 1e3, "ms")}

    def release(self):
        pass

    # -- the check ----------------------------------------------------------------------

    def check(self, precision: str = "f32"):
        t0 = time.perf_counter()
        out = [("frame_differ", *self._check_frames(precision))]
        t1 = time.perf_counter()
        if precision == "f32":
            out.append(("scene_violations", self._check_scene(), 0.0))
            t2 = time.perf_counter()
            out += self._check_chunks()
            print(f"mmbench: check of frames {self.check_frames} {t1 - t0:.3f} s, scene {t2 - t1:.3f} s, "
                  f"chunks {time.perf_counter() - t2:.3f} s", file=sys.stderr)
        return [(name, float(v), float(self.limits.get(name, lim))) for name, v, lim in out]

    def reference_frame(self, snap, precision: str = "f32"):
        """The plain reference of a checked frame: (image, DDA counts, primary dy)."""
        flight = ref_frame.Flight(*self.start_pose())
        move, rot = (0.0, 0.0, self.step), (self.turn, 0.0)
        clock, sun = 0.0, self.sun_time0
        for _ in range(snap["ticks_before"]):
            flight.step(move, rot)
            clock += self.dt
            if not self.sun_paused:
                sun += self.dt * self.eng.cfg.sun_speed
        r = self.config["render"]
        half = 2 if r["upscaling"] else 1
        w, h = r["width"] // half, r["height"] // half
        cam_prev = flight.camera(w, h, self.device)
        flight.step(move, rot)
        clock += self.dt
        if not self.sun_paused:
            sun += self.dt * self.eng.cfg.sun_speed
        cam = flight.camera(w, h, self.device)
        params = ref_frame.sky_params(sun, clock, self.device)
        flat, origin, dims = snap["scene"]
        return ref_frame.frame(Scene(flat, origin, dims), snap["history"], cam_prev, cam, params, h, w,
                               snap["ticks_before"], r["upscaling"], precision)

    def _check_frames(self, precision):
        """Channels of the checked frames that differ from the reference's; a frame the
        window did not reach, or too few frames to check, fails."""
        if len(self.check_frames) < self.n_frames or len(self.snaps) < len(self.check_frames):
            return float(2 ** 40), 0.0
        differ = 0
        counts = {}
        for i, snap in self.snaps.items():
            img, steps, dy = self.reference_frame(snap, precision)
            counts[i] = (steps, dy)
            differ += int((img != snap["image"]).sum())
        if precision == "f32":
            self.k11_counts = counts
        return float(differ), 0.0

    def _drawable(self):
        """[(chunk x, chunk z, slot)] of the scene window's drawable chunks, row-major."""
        from mega_minecraft_tpu_torch.terrain.scheduler import ChunkState

        eng, n = self.eng, self.eng.cfg.view_chunks
        ox, oz = eng.window_origin
        out = []
        for dz in range(n):
            for dx in range(n):
                p = (ox + dx, oz + dz)
                s = eng.scheduler.slot_for(p)
                if s >= 0 and eng.scheduler.state_at(p) == int(ChunkState.DRAWABLE):
                    out.append((p[0], p[1], s))
        return out

    def _check_scene(self):
        """Voxels (fine and macro) of the scene whose solidity or solid word differs from the
        fields built from the drawable blocks, or whose distance or clearance exceeds the
        built one's."""
        eng, n = self.eng, self.eng.cfg.view_chunks
        ox, oz = eng.window_origin
        blocks = torch.zeros((n, n, 16, 16, 384), dtype=torch.uint8, device=self.device)
        for cx, cz, s in self._drawable():
            blocks[cz - oz, cx - ox] = eng.scheduler.t.d_blocks[s]
        vol = blocks.permute(0, 2, 1, 3, 4).reshape(n * 16, n * 16, 384).contiguous()
        del blocks
        want = ref_frame.scene_fields(vol)
        del vol
        return scene_violations(eng.scene.flat, want, eng.scene.dims)

    def _check_chunks(self):
        """Clusters of k x k drawable chunks against the reference (none to check fails)."""
        eng, k = self.eng, self.k
        t = eng.scheduler.t
        drawable = {(cx, cz): s for cx, cz, s in self._drawable()}
        corners = sorted(c for c in drawable
                         if all((c[0] + dx, c[1] + dz) in drawable for dz in range(k) for dx in range(k)))
        pick = self.sample_rng.choice(len(corners), size=min(self.n_sites, len(corners)), replace=False)
        worst = {"blocks_differ": 0.0 if len(pick) == self.n_sites else float(2 ** 40),
                 "heightfield_max_abs": 0.0, "biome_weights_max_abs": 0.0, "caves_differ": 0.0}
        r = ref_chunk.REACH
        for j in pick:
            cx, cz = corners[int(j)]
            src = [eng.scheduler.slot_for((cx + dx, cz + dz))
                   for dz in range(-r, k + r) for dx in range(-r, k + r)]
            if min(src) < 0:
                worst["blocks_differ"] = float(2 ** 40)
                continue
            rows = torch.as_tensor(src, device=self.device)
            slots = torch.as_tensor([drawable[(cx + dx, cz + dz)] for dz in range(k) for dx in range(k)],
                                    device=self.device)
            want = ref_chunk.streamed_chunks(cx, cz, k, t.d_layers.index_select(0, rows), self.device)
            worst["blocks_differ"] += float((t.d_blocks.index_select(0, slots) != want["blocks"]).sum())
            for k, got in (("heightfield", t.d_heightfield), ("biome_weights", t.d_weights)):
                d = float((got.index_select(0, rows).double() - want[k].double()).abs().max())
                worst[f"{k}_max_abs"] = max(worst[f"{k}_max_abs"], d)
            for k, got in (("starts", t.d_cave_starts), ("ends", t.d_cave_ends),
                           ("bottom_biome", t.d_cave_bottom), ("top_biome", t.d_cave_top)):
                worst["caves_differ"] += float((got.index_select(0, rows).to(torch.int32)
                                                != want["caves"][k].to(torch.int32)).sum())
        return [(k, v, 0.0) for k, v in worst.items()]

    # -- per-layer quantities -----------------------------------------------------------

    def attempted(self):
        return len(self.frame_s)

    def k11_roofline(self, trace):
        """K11's share of its roofline on the checked frames: the need of their rays (the
        plain tracer's DDA counts on the same frames) over the device time of those frames'
        K11 launches, found by their order from the end of the trace (the profiler may drop a
        trace's first launches)."""
        from .. import roofline

        counts = getattr(self, "k11_counts", None)
        if not counts:
            return None
        frames = len(self.frame_s)
        dev_ms = need = 0.0
        for base, per in K11_KERNELS.items():
            occ = trace.occurrences(base)
            if len(occ) > per * frames:
                return None
            for k in counts:
                first = len(occ) - per * (frames - k)
                if first < 0:
                    return None
                dev_ms += sum(b - a for a, b in occ[first:first + per]) / 1e3
        for k, (steps, dy) in counts.items():
            need += roofline.bound_ms(*roofline.k11_need(steps, dy, self.snaps[k]["scene"][0].numel()))
        return 100.0 * need / dev_ms if dev_ms > 0 else None


def _level_violations(got, want, solid_of, rows: int = 32) -> int:
    """Violations in one level of a scene ([Z, X, Y] words; ``solid_of(low byte)``)."""
    zdim, _, ydim = want.shape
    yidx = torch.arange(ydim, device=want.device)
    top = torch.cat([torch.where(solid_of(want[z:z + rows] & 0xFF), yidx, -1).amax(dim=2)
                     for z in range(0, zdim, rows)])
    # columns with no solid top within the skyline radius: the descent there reaches the
    # volume's floor, and any value is safe
    sky_free = _dilate_max_2d(top, SKY_R, -1) < 0
    bad = 0
    for z in range(0, zdim, rows):
        g = got[z:z + rows].to(torch.int64) & 0xFFFFFFFF
        w = want[z:z + rows].to(torch.int64) & 0xFFFFFFFF
        gl, wl = g & 0xFF, w & 0xFF
        gs, ws = solid_of(gl), solid_of(wl)
        flag = (w >> 31) & 1
        v = gs != ws
        v |= ws & ((gl != wl) | (((g >> 31) & 1) != flag))
        v |= ~ws & (gl > wl)
        clear = ~(ws & (flag == 1))
        for shift, bits in ((8, 0x3F), (14, 0x3F), (20, 0x3F)):
            v |= clear & (((g >> shift) & bits) > ((w >> shift) & bits))
        v |= clear & ~sky_free[z:z + rows, :, None] & (((g >> 26) & 0x1F) > ((w >> 26) & 0x1F))
        bad += int(v.sum())
    return bad


def scene_violations(got_flat, want_flat, dims) -> int:
    """Voxels and macro cells of a streamed scene ``got_flat`` that break its guarantees
    against the fields ``want_flat`` built from the same blocks (dims (Z, X, Y) of the fine
    level, the macro level after it): a solidity that differs; for a solid, a block id or
    alpha flag that differs; for an empty voxel, a distance larger than the built one; for
    any voxel but an alpha-tested solid, an up / 2-slab / 8-slab clearance larger than the
    built one, or a skyline descent larger than the built one where a solid top lies within
    the skyline radius.  A streamed update may leave a distance or clearance smaller than a
    fresh build's: it stays a safe bound."""
    zdim, xdim, ydim = dims
    n_fine = zdim * xdim * ydim
    S = MACRO_SCALE
    fine = _level_violations(got_flat[:n_fine].view(dims), want_flat[:n_fine].view(dims),
                             lambda low: (low > 0) & (low < EMPTY_BASE))
    mdims = (zdim // S, xdim // S, ydim // S)
    macro = _level_violations(got_flat[n_fine:].view(mdims), want_flat[n_fine:].view(mdims),
                              lambda low: low == 0)
    return fine + macro
