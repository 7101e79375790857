"""The trace reader: the busy time is the union of the device's operations inside the
window, and the idle time is split by the benchmark's host spans that cover it."""

from __future__ import annotations

import pytest

from mmbench import tracing


class FakeProfile:
    """A finished profiler run with ``events()`` (no raw Kineto results)."""

    class Ev:
        def __init__(self, name, dev, a, b):
            import torch

            self.name = name
            self.device_type = torch.autograd.DeviceType.CUDA if dev else torch.autograd.DeviceType.CPU
            self.time_range = type("R", (), {"start": a, "end": b})()

    def __init__(self, events):
        self._ev = [self.Ev(*e) for e in events]

    def events(self):
        return self._ev


def test_busy_union_and_idle_by_host():
    prof = FakeProfile([
        ("mmbench.window", False, 0.0, 1000.0),
        ("mmbench.tick", False, 0.0, 300.0),
        ("mmbench.present", False, 300.0, 900.0),
        ("mmbench.window", True, 0.0, 1000.0),  # the profiler's device copy of a host mark
        ("void render_sample_kernel<1>(float*)", True, 100.0, 400.0),
        ("render_bounce_kernel(int)", True, 350.0, 500.0),  # overlaps the first
        ("Memcpy DtoH (Device -> Pinned)", True, 800.0, 850.0),
        ("late_kernel", True, 990.0, 1200.0),  # past the window: clipped
        ("aten::add", False, 10.0, 20.0),
    ])
    tr = tracing.Trace(prof)
    assert tr.window == (0.0, 1000.0) and tr.window_s == pytest.approx(1e-3)
    assert tr.busy_intervals() == [[100.0, 500.0], [800.0, 850.0], [990.0, 1000.0]]
    assert tr.busy_s == pytest.approx((400 + 50 + 10) / 1e6)
    assert [n for n, _ in tr.top_ops()][:2] == ["render_sample_kernel", "render_bounce_kernel"]
    idle = dict(tr.idle_by_host())
    # gaps: 0-100 (tick), 500-800 (present), 850-990 (present 850-900, then outside)
    assert idle["tick"] == pytest.approx(100 / 1e6)
    assert idle["present"] == pytest.approx((300 + 50) / 1e6)
    assert idle["outside the program's calls"] == pytest.approx(90 / 1e6)
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s)
    assert tr.occurrences("render_sample_kernel") == [(100.0, 400.0)]
    assert tr.device_seconds(("render_bounce_kernel", "late_kernel")) == pytest.approx((150 + 10) / 1e6)


@pytest.mark.parametrize("name, base", [
    ("void features_kernel<128>(int const*, int)", "features_kernel"),
    ("placements_kernel(float*)", "placements_kernel"),
    ("void compact_placements_kernel(int*)", "compact_placements_kernel"),
    ("Memset (Device)", "Memset"),
    ("void (anonymous namespace)::update_prep_kernel<4>(int const*, int)", "update_prep_kernel"),
    ("(anonymous namespace)::atrous_kernel(float const*, float*)", "atrous_kernel"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH"),
])
def test_kernel_base_names(name, base):
    assert tracing.kernel_base(name) == base
