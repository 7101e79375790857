"""Engine: streaming generation, scene updates and rendering around a fly camera.

Port of ``mega_minecraft_tpu/app/engine.py`` (the reference's app-shell tick,
main.cpp:661-717: player move -> terrain window -> budgeted generation -> camera upload ->
render; the day-night clock, optixRenderer.cpp:878-900).  One frame:

- ``tick``: the scheduler's tick (the generation kernels), the streamed chunks into
  the scene (``brickmap.update_chunks``, K10u, one per 3x3-chunk bucket), one 1-spp sample
  (K11) and its temporal accumulation (K13 when the camera moved, K13s when not; K12 with
  ``use_reprojection=False``).  It never waits for the card: the slot numbers go to K10u
  by value and the camera and sky parameters up in one pinned copy;
- ``present``: the à-trous denoise (K14), the 2x upscale (K15) and ACES (K16), then the
  frame's one copy to the host.

Every kernel runs on the engine's ``device`` ("cuda" unless the caller asks for "cpu",
where the plain versions run).  The presentation layer (D3D11 / GLFW) is not here:
``present`` returns the frame as a numpy array.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..render import brickmap, camera, denoise, reproject, sky, tonemap, tracer
from ..terrain.scheduler import ChunkState, make_scheduler
from ..utils import profiling


@dataclass
class EngineConfig:
    width: int = 640
    height: int = 360
    view_chunks: int = 33  # scene window side (chunkVbosGenRadius * 2 + 1)
    gen_radius: int | None = 8  # spiral clip radius (None: the reference's 40)
    capacity: int = 8192
    skip_erosion: bool = False
    sun_speed: float = -0.025  # rad/s (optixRenderer.cpp:885)
    sun_time0: float = 1.0
    use_denoising: bool = True  # defines.hpp:11
    use_upscaling: bool = False  # defines.hpp:12: render at half size, 2x upscale at present
    #: temporal reprojection: accumulation survives camera motion per pixel (the reference
    #: resets it, optixRenderer.cpp:458-479)
    use_reprojection: bool = True
    native_scheduler: bool | None = None  # None: the C++ core where it builds
    device: str = "cuda"

    @classmethod
    def from_config(cls, cfg=None) -> "EngineConfig":
        """Engine settings from the config tree (defaults <- MMTPU_* environment <- the
        passed Config)."""
        from .. import config as config_mod

        cfg = cfg or config_mod.load_config()
        return cls(width=cfg.render.width, height=cfg.render.height, capacity=cfg.terrain.capacity,
                   skip_erosion=cfg.terrain.skip_erosion, use_denoising=cfg.render.use_denoising,
                   use_upscaling=cfg.render.use_upscaling)


def upload_params(device, *groups):
    """Tuples of CPU f32 tensors (camera, sky parameters) -> the same tuples on ``device``,
    through one pinned copy that does not wait for the card."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return groups
    flat = [t.reshape(-1) for g in groups for t in g]
    buf = torch.cat(flat).pin_memory().to(dev, non_blocking=True)
    out, i = [], 0
    for g in groups:
        vals = []
        for t in g:
            vals.append(buf[i:i + t.numel()].view(t.shape))
            i += t.numel()
        out.append(type(g)(*vals))
    return tuple(out)


class Engine:
    """Streams terrain around the player and renders accumulated path-traced frames."""

    #: chunks per side of a scene-update bucket: the re-sweep window pads the region by
    #: DIST_CAP = 63 blocks on each side, so one chunk sweeps 142² columns and a 3x3
    #: bucket 174²: nine chunks for ~1.5x the cost of one
    UPLOAD_BUCKET = 3

    def __init__(self, cfg: EngineConfig | None = None):
        self.cfg = cfg or EngineConfig()
        self.device = torch.device(self.cfg.device)
        self.player = camera.Player()
        # zone erosion needs the full 24x24 gathered grid; under a spiral radius < 18 no
        # zone can become ready, so the reference's DEBUG_SKIP_EROSION behaviour applies
        skip_erosion = self.cfg.skip_erosion
        if not skip_erosion and self.cfg.gen_radius is not None and self.cfg.gen_radius < 18:
            skip_erosion = True
        self.scheduler = make_scheduler(self.cfg.capacity, self.cfg.gen_radius, skip_erosion,
                                        native=self.cfg.native_scheduler, device=self.device)
        n = self.cfg.view_chunks
        self.window_origin = (-(n // 2), -(n // 2))  # chunk coords of the scene's corner
        self.scene = brickmap.empty_scene(n * 16, *self.window_origin, device=self.device)
        self.time = 0.0
        self.sun_time = self.cfg.sun_time0
        self.time_paused = False
        # freecam: the camera detaches from the streaming window (main.cpp:181,701)
        self.freecam = False
        self.fps = profiling.FpsCounter()
        self.frame_id = 0
        # internal render size (half when upscaling, optixRenderer.cpp:462-466)
        half = 2 if self.cfg.use_upscaling else 1
        self.render_w, self.render_h = self.cfg.width // half, self.cfg.height // half
        self.fbs = tracer.init_framebuffers(self.render_h, self.render_w, self.device,
                                            temporal=self.cfg.use_reprojection)
        self._prev_cam = None

    # -- scene updates -----------------------------------------------------------------

    def _refresh_buckets(self, positions) -> bool:
        """Re-write the bucket-aligned scene regions covering ``positions`` from the slot
        table: DRAWABLE chunks give their blocks, the rest is air.  One K10u per bucket
        (the batched buildChunkAccel / destroyChunk)."""
        pos = [p for p in positions if self._in_window(p)]
        if not pos:
            return False
        sched = self.scheduler
        G, n = self.UPLOAD_BUCKET, self.cfg.view_chunks
        ox, oz = self.window_origin
        drawable = int(ChunkState.DRAWABLE)
        for bz, bx in sorted({((p[1] - oz) // G, (p[0] - ox) // G) for p in pos}):
            z_lo, x_lo = bz * G, bx * G
            gz, gx = min(G, n - z_lo), min(G, n - x_lo)
            slots = np.zeros(gz * gx, np.int64)
            mask = np.zeros(gz * gx, bool)
            for dz in range(gz):
                for dx in range(gx):
                    p = (ox + x_lo + dx, oz + z_lo + dz)
                    s = sched.slot_for(p)
                    if s >= 0 and sched.state_at(p) == drawable:
                        slots[dz * gx + dx], mask[dz * gx + dx] = s, True
            self.scene = brickmap.update_chunks(self.scene, sched.t.d_blocks, slots, mask, gz, gx,
                                                z_lo * 16, x_lo * 16)
        return True

    def _upload_new_chunks(self) -> bool:
        """Move newly DRAWABLE chunks into the scene (the accel-build analogue)."""
        new = list(self.scheduler.newly_filled)
        self.scheduler.newly_filled.clear()
        return self._refresh_buckets(new)

    def _remove_far_chunks(self) -> bool:
        """Clear destroyed chunks out of the scene (terrain.cpp:593-606 -> destroyChunk):
        no longer DRAWABLE, so their bucket refresh writes air."""
        gone = list(self.scheduler.vbos_destroyed)
        self.scheduler.vbos_destroyed.clear()
        return self._refresh_buckets(gone)

    def _in_window(self, p) -> bool:
        ox, oz = self.window_origin
        n = self.cfg.view_chunks
        return ox <= p[0] < ox + n and oz <= p[1] < oz + n

    # -- the frame ---------------------------------------------------------------------

    def _frame_params(self):
        cam = self.player.camera_params(self.render_w, self.render_h, device="cpu")
        params = sky.sky_params(self.sun_time, self.time, device="cpu")
        return upload_params(self.device, cam, params)

    def tick(self, dt: float, move=(0.0, 0.0, 0.0), rotate=(0.0, 0.0)):
        """One frame: input -> streaming -> scene upload -> render and accumulate."""
        cam_changed = any(move) or any(rotate)
        if any(move):
            self.player.move(*move)
        if any(rotate):
            self.player.rotate(*rotate)
        if not self.freecam:
            self.scheduler.set_player_pos(float(self.player.pos[0]), float(self.player.pos[2]))
        self.scheduler.destroy_far_vbos()
        self.scheduler.tick(dt)
        scene_changed = self._remove_far_chunks()
        scene_changed = self._upload_new_chunks() or scene_changed

        self.time += dt
        if not self.time_paused:
            self.sun_time += dt * self.cfg.sun_speed
        self.fps.tick()

        cam, params = self._frame_params()
        h, w = self.render_h, self.render_w
        if self.cfg.use_reprojection:
            # camera motion reprojects the history; scene changes invalidate only the
            # pixels whose first-hit distance moved (the depth test of both blends)
            if cam_changed and self._prev_cam is not None:
                self.fbs = reproject.render_accumulate_temporal(self.fbs, self.scene, self._prev_cam, cam,
                                                                params, h, w, self.frame_id)
            else:
                self.fbs = reproject.render_accumulate_static(self.fbs, self.scene, cam, params, h, w,
                                                              self.frame_id)
            self._prev_cam = cam
        else:
            if cam_changed or scene_changed:
                self.frame_id = 0  # reset the accumulation (optixRenderer.cpp:475)
            self.fbs = tracer.render_accumulate(self.fbs, self.scene, cam, params, h, w, self.frame_id)
        self.frame_id += 1

    def present(self) -> np.ndarray:
        """[H, W, 3] u8 tonemapped (denoised, upscaled when configured) frame on the host:
        the frame's one copy back."""
        color = self.fbs.color
        if self.cfg.use_denoising:
            nsamp = self.fbs.nsamp if self.cfg.use_reprojection else None
            color = denoise.atrous_denoise(color, self.fbs.albedo, self.fbs.normal, nsamp=nsamp)
        if self.cfg.use_upscaling:
            color = denoise.upscale2x(color)
        return tonemap.present(color).cpu().numpy()

    def drawable_chunks(self) -> int:
        return self.scheduler.drawable_count()

    # -- checkpoint / resume: the world regenerates from coordinates and seeds, so a
    #    snapshot is the camera, the clocks and the loaded-chunk set ---------------------

    def save_checkpoint(self, path: str):
        state = {
            "player": {"pos": [float(v) for v in self.player.pos], "theta": self.player.theta,
                       "phi": self.player.phi, "zoomed": self.player.zoomed},
            "time": self.time, "sun_time": self.sun_time, "time_paused": self.time_paused,
            "chunks": sorted([list(map(int, p)) for p in self.scheduler.loaded_chunks()]),
        }
        with open(path, "w") as f:
            json.dump(state, f)

    def load_checkpoint(self, path: str, regenerate: bool = True):
        """Restore the camera and clocks and (optionally) drain the regeneration of the
        chunks around the player: block content is recomputed, never stored."""
        with open(path) as f:
            state = json.load(f)
        p = state["player"]
        self.player.pos = np.asarray(p["pos"], np.float32)
        self.player.theta, self.player.phi, self.player.zoomed = p["theta"], p["phi"], p["zoomed"]
        self.time, self.sun_time = state["time"], state["sun_time"]
        self.time_paused = state.get("time_paused", False)
        self._reset_accumulation()
        self.scheduler.set_player_pos(float(self.player.pos[0]), float(self.player.pos[2]))
        if regenerate:
            self.scheduler.drain()
            self._upload_new_chunks()

    # -- debug dumps (the reference's O / V / L / X keys, terrain.cpp:1043-1144) ---------

    def _current_chunk(self):
        return (int(np.floor(self.player.pos[0] / 16.0)), int(np.floor(self.player.pos[2] / 16.0)))

    def debug_chunk_info(self) -> dict:
        """State of the chunk under the player ('O')."""
        pos = self._current_chunk()
        st = self.scheduler.state_at(pos)
        return {"chunk": pos, "state": ChunkState(st).name if st >= 0 else "UNLOADED",
                "slot": self.scheduler.slot_for(pos), "drawable": st == int(ChunkState.DRAWABLE)}

    def debug_zone_info(self) -> dict:
        """Erosion readiness and the 12x12 state grid of the player's zone ('V')."""
        cx, cz = self._current_chunk()
        zp = ((cx // 12) * 12, (cz // 12) * 12)
        grid = [[self.scheduler.state_at((zp[0] + dx, zp[1] + dz)) for dx in range(12)]
                for dz in range(12)]
        info = self.scheduler.zone_info(zp)
        info.update({"zone": zp, "state_grid": grid})
        return info

    def debug_column_layers(self) -> np.ndarray:
        """[20] material-layer start heights of the player's column ('L')."""
        cx, cz = self._current_chunk()
        slot = self.scheduler.slot_for((cx, cz))
        if slot < 0:
            return np.full(20, np.nan, np.float32)
        lx, lz = int(self.player.pos[0] - cx * 16), int(self.player.pos[2] - cz * 16)
        return self.scheduler.t.d_layers[slot, :, lz, lx].cpu().numpy()

    def debug_force_regather(self) -> dict:
        """The player chunk's heightfield regenerated from noise against the streamed slot
        ('X'): the heightfield is a function of coordinates, so a nonzero difference would
        mean a corrupt slot table."""
        from ..terrain import heightfield

        cx, cz = self._current_chunk()
        slot = self.scheduler.slot_for((cx, cz))
        if slot < 0:
            return {"chunk": (cx, cz), "slot": -1}
        pos = torch.tensor([[cx * 16, cz * 16]], dtype=torch.int32, device=self.device)
        fresh, _ = heightfield.generate_heightfield(pos)
        diff = float((fresh[0] - self.scheduler.t.d_heightfield[slot]).abs().max())
        return {"chunk": (cx, cz), "slot": slot, "regen_max_abs_diff": diff}

    # -- the renderer's controls (OptixRenderer::setZoomed / toggleTimePaused / addTime) -

    def _reset_accumulation(self):
        self.frame_id = 0
        if self.cfg.use_reprojection:
            self.fbs = tracer.init_framebuffers(self.render_h, self.render_w, self.device, temporal=True)
            self._prev_cam = None

    def set_zoomed(self, zoomed: bool):
        if zoomed != self.player.zoomed:
            self.player.zoomed = zoomed
            self._reset_accumulation()  # a fov change invalidates the accumulation

    def toggle_time_paused(self):
        self.time_paused = not self.time_paused

    def add_time(self, seconds: float):
        self.sun_time += seconds * self.cfg.sun_speed
        self._reset_accumulation()  # a lighting jump: the history is stale everywhere


def flythrough(n_frames: int = 60, cfg: EngineConfig | None = None, dt: float = 1.0 / 30.0,
               forward_per_frame: float = 2.0, warmup_drain: bool = True) -> dict:
    """Scripted fly-through: drain the initial generation, upload it, then fly forward
    ``forward_per_frame`` blocks a frame and present the last frame.  Host clock; the
    present's copy to the host ends the timed frames."""
    eng = Engine(cfg)
    t0 = time.perf_counter()
    frames = eng.scheduler.drain() if warmup_drain else 0
    gen_s = time.perf_counter() - t0
    eng._upload_new_chunks()
    t0 = time.perf_counter()
    for _ in range(n_frames):
        eng.tick(dt, move=(0.0, 0.0, forward_per_frame))
    img = eng.present()
    render_s = time.perf_counter() - t0
    return {"engine": eng, "frames": n_frames, "drain_frames": frames, "initial_gen_seconds": gen_s,
            "ms_per_frame": render_s / n_frames * 1e3, "drawable_chunks": eng.drawable_chunks(),
            "image": img}
