#!/usr/bin/env python3
"""Time K4 (chunk fill), K5 (feature placement), K7a (the per-placement stream pre-kernel),
K7 (area feature application) and K7s (the scheduler's per-chunk feature application), and
K10 (scene fields) and K10u (the streamed scene update) of two or more checkouts of the
port, in turns, on one GPU.

Usage (on a machine with a CUDA GPU), e.g. a parent commit unpacked under build/:

    python3 tools/kernel_ab.py build/parent . . build/parent [--reps 20] [--only gen|scene|render]

Each root runs in its own process, in the order given, and builds its own kernels (into
ROOT/build/mmt_kernels; the first build of a root prints ptxas's registers and spills of
the kernels timed here).  A run prints the card's name and power limit, then one JSON line:
at the 5x5 and 33x33 areas of chip_smoke.py (chunk (0, 0) and (-16, -16)), each a call (CUDA
events, warm) and on the device (torch.profiler, the mean span of each kernel's launches):
K4, K5, K7a into its own outputs (the area path) and into a slot table (the drain's
destination: 16 chunks, the 4 x 4 in the middle of the area, into a table of the area's
rows; where the root's K7a has no ``out=``, its rows and the two ``index_copy_`` the drain
made, the copies' device time under ``all``), K7, the featured slice
(generate_area_fused(..., features=True)), and K7s on those 16 chunks (their 49 sources'
lists as a slot table).  ``scene`` (with ``--only scene`` alone): K10 on the 10x10 bench
scene's volume (four featured 5x5 areas, as tools/scenelib.py tiles them) and on the featured
33x33 area's, K10u on a 3x3 bucket of the 33x33 scene (as chip_smoke.py's phase 13 times it),
each a call and on the device (every span of a call), and the fly-through's upload: the
reference drain of ``app.engine.Engine`` (bench_flythrough.py's configuration), its 121 K10u
buckets timed on the host clock ending in a synchronize, then every bucket again three times,
a refresh on the host clock and under the profiler, then twice 30 ticks 2 blocks forward and a
present (ms a frame, host clock).  ``render`` (with ``--only render`` alone): K11 on the
10x10 bench scene and the featured 33x33 area at 1080p and 540p (chip_smoke.py's camera, day,
frame 3), each a call and on the device (the mean span of each kernel, and every span of a
call in order) and a digest of its outputs (colour, albedo, normal, depth, counts; equal
digests: equal outputs), K11t on the 10x10 scene's 1080p primary rays, K17 (``render_debug``, no tint)
at 1080p on the 10x10 scene, and the fly-through's frame loop as ``scene`` runs it (the
reference drain, the upload, then twice 30 ticks and a present).  A root's first build also
prints its kernels' SASS sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import inspect
import io
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

KERNEL_NAMES = ("fill_kernel", "placements_kernel", "feature_streams_kernel", "features_kernel",
                "features_slots_kernel", "cull_kernel",
                # K10 / K10u: the kernels of csrc/brickmap.cu (and those of its earlier design)
                "scene_prep_kernel", "update_prep_kernel", "scene_round_kernel", "scene_encode_kernel",
                "solid_kernel", "macro_solid_kernel", "top_kernel", "sky_kernel", "init_kernel",
                "shift_min_kernel", "round_update_kernel", "encode_kernel", "window_kernel",
                # K11t, K11 (pass 0 and the later bounces) and K17 (csrc/tracer.cu, csrc/debug.cu)
                "trace_kernel", "render_sample_kernel", "render_bounce_kernel", "debug_shade_kernel",
                "blur_kernel")


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(torch, fn, reps):
    """{kernel name: ms a call}: each kernel of KERNEL_NAMES that ``fn`` launches once a call,
    its mean span; ``all``: every device span a call (copies included)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans, every = {}, {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            every.setdefault(ev.name, []).append(ev.time_range.end - ev.time_range.start)
            name = next((k for k in KERNEL_NAMES if re.search(rf"\b{k}\b", ev.name)), None)
            if name is not None:
                spans.setdefault(name, []).append(ev.time_range.end - ev.time_range.start)
    # every kernel's mean span times its launches a call (the profiler may drop a trace's first ones)
    total = sum(sum(v) / len(v) * max(1, round(len(v) / reps)) for v in every.values())
    return {**{k: sum(v) / len(v) / 1e3 for k, v in spans.items()}, "all": total / 1e3}


def sass_sizes(lib) -> dict:
    """{kernel: SASS instructions} of the library's kernels in KERNEL_NAMES (cuobjdump), or {} where
    the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    sizes, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = next((k for k in KERNEL_NAMES if re.search(rf"\d{k}", fn)), None)
            if name:
                sizes[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            sizes[name] += 1
    return sizes


def bench_volume(torch, pipeline, dev):
    """The 10x10 bench scene's [160, 160, 384] volume (chip_smoke.py's bench_blocks) and its
    highest heightfield value."""
    rows, hmax = [], 0.0
    for tz in range(2):
        row = []
        for tx in range(2):
            cx0, cz0 = -5 + 5 * tx, -5 + 5 * tz
            out = pipeline.generate_area_fused(pipeline.chunk_positions(cx0 - 1, cz0 - 1, 7, 7, device=dev), 5, 5,
                                               features=True)
            row.append(out["blocks"].reshape(5, 5, 16, 16, 384))
            hmax = max(hmax, float(out["heightfield"].max()))
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows, dim=0), hmax


def launch_spans(torch, fn) -> list:
    """[(kernel, ms)] of one call of ``fn`` under the profiler, in launch order (after a warm call)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((ev.time_range.start, ev.name, (ev.time_range.end - ev.time_range.start) / 1e3)
                 for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA)
    return [(next((k for k in KERNEL_NAMES if re.search(rf"\b{k}\b", name)), name[:40]), round(ms, 4))
            for _, name, ms in evs]


def scene_worker(torch, out: dict, reps: int, dev) -> None:
    """K10 at 10x10 and 33x33, K10u on a 3x3 bucket of the 33x33 scene, the 121-bucket upload."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.render import brickmap
    from mega_minecraft_tpu_torch.terrain import pipeline

    blocks33 = pipeline.generate_area(-16, -16, 33, 33, features=True, device=dev)["blocks"]
    for tag, blocks in (("10x10", bench_volume(torch, pipeline, dev)[0]), ("33x33", blocks33)):
        vol = brickmap.scene_volume(blocks)
        out[f"scene_fields_{tag}_ms"] = cuda_ms(torch, lambda: kernels.scene_fields(vol), max(3, reps // 4))
        out[f"scene_fields_{tag}_dev"] = device_ms(torch, lambda: kernels.scene_fields(vol), max(3, reps // 4))
        out[f"scene_fields_{tag}_spans"] = launch_spans(torch, lambda: kernels.scene_fields(vol))
    scene = brickmap.build_scene(blocks33, -16, -16)
    slot_table = blocks33.reshape(33 * 33, 16, 16, 384)
    slots = [(2 * 3 + dz) * 33 + 7 * 3 + dx for dz in range(3) for dx in range(3)]
    args = (slot_table, slots, [True] * 9, 3, 3, 4 * 48, 5 * 48)
    out["update_chunks_ms"] = cuda_ms(torch, lambda: brickmap.update_chunks(scene, *args), reps)
    out["update_chunks_dev"] = device_ms(torch, lambda: brickmap.update_chunks(scene, *args), reps)
    out["update_chunks_spans"] = launch_spans(torch, lambda: brickmap.update_chunks(scene, *args))
    del scene, slot_table, blocks33
    torch.cuda.empty_cache()
    eng = reference_engine(torch)
    new = list(eng.scheduler.newly_filled)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng._upload_new_chunks()
    torch.cuda.synchronize()
    out["upload_s"] = time.perf_counter() - t0
    out["upload_buckets"] = kernels.launch_counts()["update_chunks"]
    refresh = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng._refresh_buckets(new)
        torch.cuda.synchronize()
        refresh.append(time.perf_counter() - t0)
    out["refresh_s"] = refresh
    out["refresh_dev_s"] = device_ms(torch, lambda: eng._refresh_buckets(new), 1)["all"] / 1e3
    out["flythrough_ms_frame"] = fly_loop(torch, eng)


def reference_engine(torch):
    """The fly-through's engine (bench_flythrough.py's configuration) after its drain."""
    from mega_minecraft_tpu_torch.app.engine import Engine, EngineConfig

    cfg = EngineConfig(width=1920, height=1080, view_chunks=33, gen_radius=None, skip_erosion=False,
                       use_denoising=True, use_upscaling=True, use_reprojection=True, native_scheduler=True,
                       device="cuda")
    eng = Engine(cfg)
    eng.scheduler.drain()
    torch.cuda.synchronize()
    return eng


def fly_loop(torch, eng) -> list:
    """The fly-through's frame loop after the upload (no K10u in it: the window stays put), as
    chip_smoke.py's phase 14 times it: 30 ticks 2 blocks forward and one present, twice; ms a
    frame on the host clock."""
    fly = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(30):
            eng.tick(1.0 / 30.0, move=(0.0, 0.0, 2.0))
        eng.present()
        fly.append((time.perf_counter() - t0) / 30 * 1e3)
    return fly


def render_worker(torch, out: dict, reps: int, dev) -> None:
    """K11 at 1080p and 540p on the 10x10 and 33x33 scenes, K11t, K17, the fly-through's loop."""
    import numpy as np

    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.render import brickmap, camera, render_debug, sky, tracer
    from mega_minecraft_tpu_torch.terrain import pipeline

    blocks10, hmax = bench_volume(torch, pipeline, dev)
    player = camera.Player(pos=np.array([0.0, hmax + 16.0, -60.0], np.float32), theta=0.05, phi=-0.22)
    day = sky.sky_params(1.0, 0.0, device=dev)
    scene10 = brickmap.build_scene(blocks10, -5, -5)
    cam = player.camera_params(1920, 1080, device=dev)
    rays, _ = tracer.primary_rays(cam, 1080, 1920, 0)
    med = torch.zeros((1080, 1920), dtype=torch.uint8, device=dev)
    out["trace_ms"] = cuda_ms(torch, lambda: tracer.trace(scene10, *rays, med), reps)
    out["trace_dev"] = device_ms(torch, lambda: tracer.trace(scene10, *rays, med), reps)
    out["render_debug_ms"] = cuda_ms(torch, lambda: render_debug(scene10, cam, day, 1080, 1920), max(3, reps // 4))
    out["render_debug_dev"] = device_ms(torch, lambda: render_debug(scene10, cam, day, 1080, 1920),
                                        max(3, reps // 4))
    blocks33 = pipeline.generate_area(-16, -16, 33, 33, features=True, device=dev)["blocks"]
    scene33 = brickmap.build_scene(blocks33, -16, -16)
    del blocks33, blocks10
    for tag, scene in (("10x10", scene10), ("33x33", scene33)):
        for h, w in ((1080, 1920), (540, 960)):
            cam_hw = player.camera_params(w, h, device=dev)

            def k11(scene=scene, cam_hw=cam_hw, h=h, w=w):
                return tracer.render_sample(scene, cam_hw, day, h, w, 3)

            digest = hashlib.sha256()
            for t in tracer.render_sample(scene, cam_hw, day, h, w, 3, want_depth=True, want_steps=True):
                digest.update(t.cpu().numpy().tobytes())
            out[f"render_sample_{tag}_{h}_sha256"] = digest.hexdigest()[:16]  # equal across roots: bit for bit
            out[f"render_sample_{tag}_{h}_ms"] = cuda_ms(torch, k11, reps)
            out[f"render_sample_{tag}_{h}_dev"] = device_ms(torch, k11, reps)
            out[f"render_sample_{tag}_{h}_spans"] = launch_spans(torch, k11)
            if hasattr(kernels, "render_launches"):
                out[f"render_sample_{tag}_{h}_launches"] = kernels.render_launches()
    del scene10, scene33
    torch.cuda.empty_cache()
    eng = reference_engine(torch)
    eng._upload_new_chunks()
    out["flythrough_ms_frame"] = fly_loop(torch, eng)


def worker(root: str, reps: int, only: str | None) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from mega_minecraft_tpu_torch import kernels, tables
    from mega_minecraft_tpu_torch.kernels import _build
    from mega_minecraft_tpu_torch.terrain import caves, feature_placement as fp, pipeline

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _, build_s, built = _build.build(verbose=True)
    if built:  # ptxas's lines for the kernels timed here, and their SASS instructions
        lines = log.getvalue().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(k in line for k in KERNEL_NAMES):
                print(line.split("'")[1], "|", lines[i + 2].strip(), "|", lines[i + 3].strip())
        print("SASS instructions:", sass_sizes(_build.BUILD_DIR / _build.LIB_NAME))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"root": root, "card": smi, "build_s": round(build_s, 1)}
    if only == "render":
        render_worker(torch, out, reps, dev)
        print(json.dumps(out))
        return
    if only != "gen":
        scene_worker(torch, out, reps, dev)
    if only == "scene":
        print(json.dumps(out))
        return
    table = (tables.LUSH_TABLE_CELLS,) if "table_cells" in inspect.signature(kernels.fill).parameters else ()
    in_place = "out" in inspect.signature(kernels.feature_streams).parameters
    for n, first in ((5, -1), (33, -17)):  # the areas' first halo chunk, as chip_smoke.py's
        pos = pipeline.chunk_positions(first, first, n + 2, n + 2, device=dev)
        hf, w = kernels.heightfield(pos)
        st = kernels.layers(hf, w, pos, n, n)
        cv = kernels.caves(st["heightfield"], st["biome_weights"], st["chunk_pos"], caves.CELL_TABLE_CAP)
        args4 = (st["heightfield"], st["biome_weights"], st["layers"], cv["starts"], cv["ends"], st["chunk_pos"])
        base = kernels.fill(*args4, *table)
        args5 = (*args4[:5], cv["bottom_biome"], cv["top_biome"], st["chunk_pos"])
        grids = kernels.placements(*args5)
        lists = kernels.compact_placements(grids, st["chunk_pos"])
        streams = kernels.feature_streams(lists["surface"], lists["cave"])
        calls = {"fill": lambda: kernels.fill(*args4, *table),
                 "placements": lambda: kernels.placements(*args5),
                 "feature_streams": lambda: kernels.feature_streams(lists["surface"], lists["cave"]),
                 "features": lambda: kernels.features(base, lists["surface"], lists["cave"], *streams,
                                                      st["chunk_pos"], n, n)}
        if n == 33:  # K7s on the middle 4 x 4 chunks, the area's lists as the slot table
            sel = [(16 + dz) * 33 + 16 + dx for dz in range(4) for dx in range(4)]
            nslots = torch.tensor([[(sz + int(oz)) * 33 + sx + int(ox) for ox, oz in fp.GATHER_OFFSETS]
                                   for sz, sx in (divmod(b, 33) for b in sel)], dtype=torch.int32, device=dev)
            rows = torch.tensor(sel, device=dev)
            blocks16, pos16 = base[rows].contiguous(), st["chunk_pos"][rows].contiguous()
            calls["features_slots"] = lambda: kernels.features_slots(
                blocks16, lists["surface"], lists["cave"], *streams, nslots, pos16)
            # K7a's drain destination: the 16 chunks' lists into the slot table's rows
            sub = {kind: {k: v[rows].contiguous() for k, v in d.items()} for kind, d in lists.items()}
            slot_table = tuple(torch.zeros_like(v) for v in streams)
            rows32 = rows.to(torch.int32)

            def drain_streams():
                if in_place:
                    kernels.feature_streams(sub["surface"], sub["cave"], out=slot_table, rows=rows32)
                else:
                    for dst, src in zip(slot_table, kernels.feature_streams(sub["surface"], sub["cave"])):
                        dst.index_copy_(0, rows, src)
            calls["feature_streams_drain"] = drain_streams
        for name, fn in calls.items():
            out[f"{name}_{n}_ms"] = cuda_ms(torch, fn, reps if n == 5 else max(3, reps // 5))
            out[f"{name}_{n}_dev"] = device_ms(torch, fn, reps if n == 5 else max(3, reps // 5))
        out[f"slice_{n}_ms"] = cuda_ms(torch, lambda: pipeline.generate_area_fused(pos, n, n, features=True),
                                       reps if n == 5 else max(3, reps // 5))
    print(json.dumps(out))


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("roots", nargs="+", help="checkouts of the port, run in this order")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--only", choices=("gen", "scene", "render"),
                   help="time only the generation, the scene or the render kernels")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(args.roots[0], args.reps, args.only)
        return
    for root in args.roots:
        run = subprocess.run([sys.executable, __file__, "--worker", root, "--reps", str(args.reps)]
                             + (["--only", args.only] if args.only else []), capture_output=True, text=True)
        print(run.stdout, end="")
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"kernel_ab: the run of {root} failed ({run.returncode})")


if __name__ == "__main__":
    main(sys.argv[1:])
