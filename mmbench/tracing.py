"""What the benchmark records around its calls into the program, and what it reads from the
profiler's trace.

``Spans`` times each call on the host clock (``time.perf_counter``) and, in a traced run, marks
it for the profiler too (``torch.profiler.record_function``), so that the device's idle gaps
can be laid against what the host was doing.  ``Trace`` reads a ``torch.profiler`` run: the
device's operations (kernels, copies, fills) and the benchmark's own host spans, on the
profiler's one clock; the busy time is the union of the device operations inside the window.
"""

from __future__ import annotations

import contextlib
import re
import time

#: the prefix of the benchmark's host spans in a trace
PREFIX = "mmbench."


class Spans:
    """Host-clock spans by name: [(start_s, end_s)] on ``time.perf_counter``."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.by_name: dict[str, list[tuple[float, float]]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        mark = contextlib.nullcontext()
        if self.traced:
            import torch

            mark = torch.profiler.record_function(PREFIX + name)
        t0 = time.perf_counter()
        with mark:
            yield
        self.by_name.setdefault(name, []).append((t0, time.perf_counter()))

    def mean_ms(self, name: str) -> float | None:
        spans = self.by_name.get(name)
        if not spans:
            return None
        return sum(b - a for a, b in spans) / len(spans) * 1e3


def kernel_base(name: str) -> str:
    """A device operation's function name without its return type, template and arguments
    (``void features_kernel<128>(int*, ...)`` -> ``features_kernel``)."""
    name = name.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    if not head:
        return name or "(unnamed)"
    if head.startswith(("Memcpy", "Memset")):
        return head
    return head.split()[-1].split("::")[-1]


def _events(prof):
    """(name, is_device, start_us, end_us) of every event of a finished profiler run, from
    the raw Kineto events where this torch has them (no tree is built), else
    ``prof.events()``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None and hasattr(raw, "events"):
        out = []
        for e in raw.events():
            if hasattr(e, "start_ns"):
                start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
            else:
                start, dur = float(e.start_us()), e.duration_us()
            out.append((e.name(), e.device_type() == cuda, start, start + dur))
        return out
    return [(e.name, e.device_type == cuda, e.time_range.start, e.time_range.end) for e in prof.events()]


class Trace:
    """The device operations and the benchmark's host spans of a traced window.

    ``ops``: [(base name, start_us, end_us)] of the device's kernels, copies and fills,
    sorted by start; ``spans``: [(name without the prefix, start_us, end_us)] of the host;
    ``window``: (start_us, end_us) of the span named ``window``."""

    def __init__(self, prof):
        self.ops, self.spans = [], []
        for name, is_dev, a, b in _events(prof):
            if name.startswith(PREFIX):
                if not is_dev:
                    self.spans.append((name[len(PREFIX):], a, b))
            elif is_dev:
                self.ops.append((kernel_base(name), a, b))
        self.ops.sort(key=lambda o: o[1])
        self.spans.sort(key=lambda s: s[1])
        windows = [(a, b) for n, a, b in self.spans if n == "window"]
        if not windows:
            raise RuntimeError("the trace holds no window span")
        self.window = windows[0]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self):
        """Merged [start_us, end_us] intervals in which a device operation ran, clipped to the
        window."""
        lo, hi = self.window
        merged = []
        for _, a, b in self.ops:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def occurrences(self, base: str):
        """[(start_us, end_us)] of the device operation ``base``, in order of start."""
        return [(a, b) for n, a, b in self.ops if n == base]

    def device_seconds(self, bases) -> float:
        """Seconds of the device operations named in ``bases`` inside the window."""
        lo, hi = self.window
        return sum(min(b, hi) - max(a, lo) for n, a, b in self.ops
                   if n in bases and min(b, hi) > max(a, lo)) / 1e6

    def top_ops(self, k: int = 10):
        """[[base name, seconds]] of the k device operations that took the most time in the
        window."""
        lo, hi = self.window
        tot: dict[str, float] = {}
        for n, a, b in self.ops:
            d = min(b, hi) - max(a, lo)
            if d > 0:
                tot[n] = tot.get(n, 0.0) + d / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_by_host(self, k: int = 10):
        """[[what the host was doing, seconds]]: the device's idle time inside the window,
        each gap split by the benchmark's host spans that cover it, the rest "outside the
        program's calls"; the k largest."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        spans = [(n, a, b) for n, a, b in self.spans if n != "window"]
        tot: dict[str, float] = {}
        # the spans other than the window follow one another (none nests in another), so
        # their ends rise with their starts: none before ``first`` reaches a later gap
        first = 0
        for ga, gb in gaps:
            while first < len(spans) and spans[first][2] <= ga:
                first += 1
            covered = []
            for n, a, b in spans[first:]:
                if a >= gb:
                    break
                if b > ga:
                    covered.append((max(a, ga), min(b, gb), n))
            rest = gb - ga
            for a, b, n in covered:
                tot[n] = tot.get(n, 0.0) + (b - a) / 1e6
                rest -= b - a
            if rest > 0:
                tot["outside the program's calls"] = tot.get("outside the program's calls", 0.0) + rest / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]
