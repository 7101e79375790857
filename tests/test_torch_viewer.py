"""The port's viewer (``mega_minecraft_tpu_torch/app/viewer.py``): the counterparts of
``tests/test_viewer.py`` — input routing (the MsgProc/keyCallback analogue,
main.cpp:292-490), PNG encoding, terminal frame conversion and the HTTP page — against a
stub engine, so no kernel and no JAX runs; plus the ``--device`` switch into
``EngineConfig``.  The values are equal to JAX's (no tolerance): the viewer is a copy."""

import json
import struct
import zlib

import numpy as np
import pytest
import torch

from mega_minecraft_tpu_torch.app import viewer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubPlayer:
    def __init__(self):
        self.pos = np.array([1.0, 2.0, 3.0], np.float32)


class StubEngine:
    """Duck-typed Engine capturing routed calls."""

    def __init__(self):
        self.player = StubPlayer()
        self.calls = []
        self.zoomed = False
        self.freecam = False
        self.time_paused = False

    def set_zoomed(self, z):
        self.zoomed = z

    def toggle_time_paused(self):
        self.time_paused = not self.time_paused

    def add_time(self, s):
        self.calls.append(("add_time", s))

    def debug_chunk_info(self):
        return {"chunk": [0, 0]}

    def debug_zone_info(self):
        return {"zone": [0, 0], "state_grid": []}

    def debug_column_layers(self):
        return np.zeros(20, np.float32)

    def tick(self, dt, move=(0, 0, 0), rotate=(0, 0)):
        self.calls.append(("tick", dt, move, rotate))


class TestRoutedTick:
    def _tick(self, held=(), events=(), rot=(0.0, 0.0), dt=0.1):
        eng = StubEngine()
        state = viewer.InputState()
        state.update({"held": list(held), "dtheta": rot[0], "dphi": rot[1],
                      "events": list(events)})
        viewer.routed_tick(eng, state, dt, log=lambda m: None)
        return eng

    def test_wasd_movement_scaling(self):
        # W for dt=0.1 at sensitivity 10 -> +1.0 forward (main.cpp:175,692)
        eng = self._tick(held=["w"])
        _, dt, move, _ = eng.calls[-1]
        assert move == (0.0, 0.0, 1.0)
        # shift -> x8; shift+alt -> x32; alt -> x0.25 (main.cpp:677-690)
        assert self._tick(held=["w", "shift"]).calls[-1][2][2] == 8.0
        assert self._tick(held=["w", "shift", "alt"]).calls[-1][2][2] == 32.0
        assert self._tick(held=["w", "alt"]).calls[-1][2][2] == 0.25
        # A is +x, D is -x (reference right-handed basis, main.cpp:307-313)
        assert self._tick(held=["a"]).calls[-1][2][0] == 1.0
        assert self._tick(held=["d"]).calls[-1][2][0] == -1.0
        # E/space up, Q down at sensitivity 8
        assert self._tick(held=["e"]).calls[-1][2][1] == 0.8
        assert self._tick(held=["q"]).calls[-1][2][1] == -0.8

    def test_arrows_and_mouse_rotation(self):
        eng = self._tick(held=["arrowleft", "arrowup"])
        _, _, _, rot = eng.calls[-1]
        assert rot == (viewer.ARROW_STEP, viewer.ARROW_STEP)
        eng = self._tick(rot=(0.05, -0.02))
        assert eng.calls[-1][3] == (0.05, -0.02)

    def test_oneshot_events(self):
        eng = self._tick(events=["p"])
        assert eng.time_paused
        eng = self._tick(events=["["])
        assert ("add_time", -5.0) in eng.calls
        eng = self._tick(events=["]"])
        assert ("add_time", 5.0) in eng.calls
        eng = self._tick(events=["f"])
        assert eng.freecam
        eng = self._tick(held=["c"])
        assert eng.zoomed

    def test_escape_quits(self):
        eng = StubEngine()
        state = viewer.InputState()
        state.update({"events": ["escape"]})
        viewer.routed_tick(eng, state, 0.1, log=lambda m: None)
        assert state.quit

    def test_drain_clears_deltas(self):
        state = viewer.InputState()
        state.update({"dtheta": 1.0, "events": ["k"]})
        state.drain()
        _, rot, events = state.drain()
        assert rot == (0.0, 0.0) and events == []


class TestEncodePng:
    def test_roundtrip(self):
        rng = np.random.RandomState(0)
        img = rng.randint(0, 256, (7, 5, 3), np.uint8)
        png = viewer.encode_png(img)
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        w, h = struct.unpack(">II", png[16:24])
        assert (w, h) == (5, 7)
        # decode the IDAT back and compare
        i = png.index(b"IDAT")
        (n,) = struct.unpack(">I", png[i - 4 : i])
        raw = zlib.decompress(png[i + 4 : i + 4 + n])
        rows = np.frombuffer(raw, np.uint8).reshape(7, 1 + 5 * 3)[:, 1:]
        np.testing.assert_array_equal(rows.reshape(7, 5, 3), img)


class TestTerminalFrames:
    def test_ansi_shape_and_colors(self):
        img = np.zeros((8, 16, 3), np.uint8)
        img[:4] = [255, 0, 0]
        img[4:] = [0, 0, 255]
        s = viewer._frame_to_ansi(img, cols=8)
        assert s.startswith("\x1b[H")
        assert "38;2;255;0;0" in s and "48;2;0;0;255" in s
        # cols=8 on a 16x8 frame -> 4 scaled rows -> 2 half-block lines of 8 cells
        assert s.count("▀") == 8 * 2


class TestPageServes:
    def test_http_handler_smoke(self):
        # the page template substitutes dimensions and is valid utf-8 html
        page = viewer._PAGE.replace("%W%", "64").replace("%H%", "48")
        assert "<html>" in page and "64" in page
        json.dumps({"held": ["w"], "events": []})  # the wire format is plain JSON


class TestMain:
    def test_device_switch_reaches_the_engine_config(self, monkeypatch):
        seen = {}
        monkeypatch.setattr(viewer, "run_terminal_viewer", lambda cfg, cols, max_frames: seen.update(
            cfg=cfg, cols=cols, max_frames=max_frames))
        viewer.main(["--term", "--device", "cpu", "--max-frames", "3", "--upscale"])
        cfg = seen["cfg"]
        assert (cfg.device, cfg.width, cfg.height, cfg.use_upscaling) == ("cpu", 640, 360, True)
        assert (cfg.gen_radius, cfg.view_chunks, seen["max_frames"]) == (8, 17, 3)
        monkeypatch.setattr(viewer, "run_http_viewer", lambda cfg, host, port, max_frames: seen.update(cfg=cfg))
        viewer.main([])
        assert seen["cfg"].device == "cuda"
