"""Per-stage timers of the streaming scheduler and the engine's frame counter (port of
``mega_minecraft_tpu/utils/profiling.py`` ``StageTimer`` and ``FpsCounter``).

The scheduler's stage dispatches only enqueue device work, so a host clock around one
measures the enqueue.  A ``StageTimer`` built with a CUDA ``device`` synchronises that
device when a stage starts and when it ends, so each stage's time is its host work plus
its device work.  That synchronisation is the timer's own cost: a scheduler with no
timer attached never synchronises.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


class StageTimer:
    """Accumulates wall time and calls per named stage.

    >>> timer = StageTimer(device)
    >>> with timer.stage("fill"):
    ...     run_fill()
    >>> timer.report()["fill"]["seconds"]
    """

    def __init__(self, device=None):
        device = torch.device(device) if device is not None else None
        self.cuda = device if device is not None and device.type == "cuda" else None
        self.total_s = defaultdict(float)
        self.calls = defaultdict(int)

    def _sync(self):
        if self.cuda is not None:
            torch.cuda.synchronize(self.cuda)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.total_s[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def report(self) -> dict:
        """{stage: {"seconds", "calls"}}, the longest stage first."""
        return {name: {"seconds": s, "calls": self.calls[name]}
                for name, s in sorted(self.total_s.items(), key=lambda kv: -kv[1])}


@dataclass
class FpsCounter:
    """Frame timer and rolling frames per second on the host clock (the title-bar
    counter of the reference's app shell)."""

    window: float = 1.0
    _t_last: float = field(default_factory=time.perf_counter)
    _acc: float = 0.0
    _frames: int = 0
    fps: float = 0.0
    last_dt: float = 0.0

    def tick(self) -> float:
        """Call once per frame; returns the seconds since the previous tick."""
        now = time.perf_counter()
        self.last_dt = now - self._t_last
        self._t_last = now
        self._acc += self.last_dt
        self._frames += 1
        if self._acc >= self.window:
            self.fps = self._frames / self._acc
            self._acc = 0.0
            self._frames = 0
        return self.last_dt
