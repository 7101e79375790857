"""The benchmark's command: one run of one cell.

    python -m mmbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``) runs from the start of this module to the window: torch's import, the
program's build (its kernel library and native scheduler, cached in the checkout's
``build/``), the cell's inputs made from the seed, and the warm-up of every shape the window
uses.  The window runs ``--seconds`` seconds.  With ``--trace 0`` the result's metrics are
the cell's end-to-end metrics of ``BENCHMARK.json``; with ``--trace 1`` the window runs under
``torch.profiler`` and the metrics are the cell's per-layer metrics.  After the window the
peak device memory is read, then the plain reference checks the program's outputs: each
number compared and its limit are printed as the last lines of standard error and, under
the last key ``compared``, in the result, which is the last line of standard output.

Exits 3 without a result where torch sees no CUDA card or fewer than the cell asks for, and
4 where the process has loaded JAX, Flax or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import spec, tracing  # noqa: E402

#: top-level module names that no run may load (the JAX package is the reference of the
#: port's CPU tests, never of the benchmark)
FORBIDDEN = ("jax", "jaxlib", "flax", "mega_minecraft_tpu")


def forbidden_modules() -> list[str]:
    """The top-level names of ``sys.modules`` that are in ``FORBIDDEN``, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


#: glibc ``mallopt`` parameters and the values the run fixes: host blocks up to 64 MiB come
#: from the heap and the heap is not trimmed below 1 GiB
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
MALLOC = ((M_MMAP_THRESHOLD, 64 << 20), (M_TRIM_THRESHOLD, 1 << 30))


def steady_host_allocator():
    """Fix glibc's malloc thresholds for this process.  ``Engine.present`` allocates a new
    6.2 MB host array for every frame; under glibc's default, self-adjusting thresholds
    each process either serves it from the heap or maps fresh memory for it, which made a
    frame 3.5 or 6-7.7 ms by the luck of the process on an H100 host.  With fixed
    thresholds every run serves it from the heap."""
    import ctypes
    import ctypes.util

    name = ctypes.util.find_library("c")
    if name is None:
        return
    libc = ctypes.CDLL(name)
    if not hasattr(libc, "mallopt"):
        return
    for param, value in MALLOC:
        libc.mallopt(param, value)


def prepare_environment():
    """Build and kernel caches at fixed paths inside the checkout; no configuration override
    of the program (``MMTPU_*``) and no Flax or JAX back end for a library that would load
    one; a steady host allocator."""
    steady_host_allocator()
    build = spec.ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for key in [k for k in os.environ if k.startswith("MMTPU_")]:
        del os.environ[key]


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m mmbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def build(name: str, seed: int, seconds: float, traced: bool, device):
    """The cell's workload object, before its set-up (the tests drive it from here too)."""
    bench = spec.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"mmbench: BENCHMARK.json has no workload {name!r}")
    cell = spec.cell(name)
    if cell["config"] != entry["config"] or cell["traffic"]["name"] != entry["traffic"]:
        raise SystemExit(f"mmbench: cells/{name}.json disagrees with BENCHMARK.json")
    config = spec.config(cell["config"])
    mod = spec.traffic(cell["traffic"]["kind"])
    return entry, mod.Workload(cell, config, seed, seconds, tracing.Spans(traced), device)


def measure(wl, traced: bool):
    """Set-up, the window and the peak memory.  Returns (setup_s, trace or None, peak)."""
    import torch

    from .traffic import sync

    wl.setup()
    sync(wl.device)
    setup_s = time.perf_counter() - START
    trace = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with wl.spans.span("window"):
                wl.window()
                sync(wl.device)
        trace = tracing.Trace(prof)
        del prof
    else:
        with wl.spans.span("window"):
            wl.window()
            sync(wl.device)
    peak = torch.cuda.max_memory_allocated(wl.device) if wl.device.type == "cuda" else 0
    return setup_s, trace, peak


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    prepare_environment()
    import torch

    device = torch.device("cuda", 0)
    entry, wl = build(args.workload, args.seed, args.seconds, args.trace == 1, device)
    chips = entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mmbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one intra-op thread: the program's host-side tensor work is a few tiny operations a
    # frame, and a pool of spinning threads on a shared host only adds jitter
    torch.set_num_threads(1)
    torch.cuda.set_device(device)
    e2e, per_layer = spec.metrics_of(spec.benchmark(), args.workload)

    setup_s, trace, peak = measure(wl, args.trace == 1)
    t_window = time.perf_counter()
    metrics = {}
    if trace is None:
        values = dict(wl.end_to_end(), setup_s=(setup_s, "s"))
        for m in e2e:
            value, unit = values[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    attempted = wl.attempted()
    wl.release()
    t_check = time.perf_counter()
    readings = wl.check()
    t_layers = time.perf_counter()
    if trace is not None:
        for m in per_layer:
            reader = spec.layer_reader(m["name"])
            value = reader.read(wl, trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": reader.UNIT}

    print(f"mmbench: set-up {setup_s:.3f} s, window and trace reading {t_check - START - setup_s:.3f} s "
          f"(from the window's end {t_check - t_window:.3f} s), check {t_layers - t_check:.3f} s, per-layer "
          f"readers {time.perf_counter() - t_layers:.3f} s", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"mmbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    failed = sum(1 for _, v, lim in readings if not v <= lim)
    device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                  "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_rec}
    if trace is not None:
        device_rec["busy_s"] = trace.busy_s
        device_rec["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_by_host()}
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in readings}
    for name, v, lim in readings:
        print(f"compared {name}: {v!r} (limit {lim!r}){'' if v <= lim else '  FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0
