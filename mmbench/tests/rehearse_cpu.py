"""A rehearsal of both traffic kinds on the CPU at a tiny size, through the port's plain
versions: set-up, a short window, the end-to-end metrics, the check and its control.

    python -m mmbench.tests.rehearse_cpu [log]

The sizes are cut far below the cells' (a 3x3 area, 2x2 clusters checked; a 5x5-chunk scene window over a radius-5
world without erosion, 64x36 frames, a circle of 8 blocks at y = 240), so its times say nothing of the
card: it shows that the paths, shapes and the check run, and that the control fails.
"""

from __future__ import annotations

import sys
import time

import torch

from mmbench import spec, tracing

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977


def tiny_pregen():
    from mmbench.traffic import pregen

    cell = spec.cell("pregen33_featured")
    # one area in flight: on the CPU a call returns its finished area
    cell["traffic"].update(area_chunks=3, warm_areas=1, in_flight=1)
    cell["check"].update(cluster=2)
    return pregen.Workload(cell, spec.config(cell["config"]), SEED, 15.0, tracing.Spans(False), CPU)


def tiny_flyloop(seconds: float = 2.0):
    from mmbench.traffic import flyloop

    cell = spec.cell("flyloop_540up")
    # above the hill at the origin, whose top (y ~ 215) the cell's y = 200 flies through
    cell["traffic"].update(radius_blocks=8.0, warmup_laps=1, y=240.0)
    cell["check"].update(frames=1, frame_range=[1, 2], cluster=2)
    cfg = spec.config(cell["config"])
    cfg["world"].update(gen_radius=5, view_chunks=5, erosion=False)
    cfg["render"].update(width=64, height=36)
    return flyloop.Workload(cell, cfg, SEED, seconds, tracing.Spans(False), CPU)


def rehearse(make, log):
    wl = make()
    t = time.perf_counter()
    wl.setup()
    log(f"  set-up {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    wl.window()
    log(f"  window {time.perf_counter() - t:.1f} s, attempted {wl.attempted()}; end to end {wl.end_to_end()}")
    wl.release()
    for precision in ("f32", "bf16"):
        t = time.perf_counter()
        got = wl.check(precision)
        ok = all(v <= lim for _, v, lim in got)
        log(f"  check {precision} ({time.perf_counter() - t:.1f} s): correct={ok}; "
            + ", ".join(f"{n} {v!r} (limit {lim!r})" for n, v, lim in got))


def main(argv):
    torch.set_num_threads(4)
    out = open(argv[0], "w") if argv else None

    def log(msg):
        print(msg, flush=True)
        if out:
            out.write(msg + "\n")

    log(f"CPU rehearsal, torch {torch.__version__}, seed {SEED}; not a device measurement")
    log("pregen: a 3x3 featured area a call")
    rehearse(tiny_pregen, log)
    log("flyloop: a 5x5-chunk scene, radius-5 world without erosion, 64x36 upscaled from 32x18")
    rehearse(tiny_flyloop, log)
    if out:
        out.close()


if __name__ == "__main__":
    main(sys.argv[1:])
