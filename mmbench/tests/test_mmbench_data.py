"""A configuration, a cell or a per-layer metric is added as new files alone: the harness
finds each by its name, with no edit to a file that is already there."""

from __future__ import annotations

import json
import shutil

import torch

import mmbench.layer_metrics
from mmbench import run, spec, tracing

CPU = torch.device("cpu")


def _tree(tmp_path, monkeypatch):
    """A copy of the benchmark's data files under tmp_path, which ``spec`` then reads."""
    root = tmp_path / "root"
    here = root / "mmbench"
    for sub in ("cells", "configs"):
        shutil.copytree(spec.HERE / sub, here / sub)
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "ROOT", root)
    return root, here


def test_a_new_cell_and_configuration_are_new_files(tmp_path, monkeypatch):
    root, here = _tree(tmp_path, monkeypatch)
    before = {p.name: p.read_bytes() for p in (here / "cells").iterdir()}
    cfg = json.loads((here / "configs" / "mm_ref_upscaled.json").read_text())
    cfg["name"] = "mm_test_night"
    (here / "configs" / "mm_test_night.json").write_text(json.dumps(cfg))
    cell = json.loads((here / "cells" / "flyloop_540up.json").read_text())
    cell.update(name="flyloop_night_test", config="mm_test_night")
    cell["traffic"].update(name="circle32_night", sun_time=4.0)
    (here / "cells" / "flyloop_night_test.json").write_text(json.dumps(cell))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "flyloop_night_test", "config": "mm_test_night",
                               "traffic": "circle32_night", "chips": 1, "why": "night"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    entry, wl = run.build("flyloop_night_test", 11, 2.0, False, CPU)
    assert entry["config"] == "mm_test_night" and wl.sun_time0 == 4.0
    assert wl.config["name"] == "mm_test_night"
    assert {p.name: p.read_bytes() for p in (here / "cells").iterdir() if p.name in before} == before
    e2e, per_layer = spec.metrics_of(bench, "flyloop_night_test")
    # a metric without a workloads key (setup_s) reaches the new cell too
    assert "setup_s" in {m["name"] for m in e2e}


def test_a_new_per_layer_metric_is_a_new_module(tmp_path, monkeypatch):
    pkg = tmp_path / "metrics"
    pkg.mkdir()
    (pkg / "frames_counted.py").write_text(
        'UNIT = "frames"\nLAYER = "engine"\nMOVES = "frame_ms"\n\n\n'
        "def read(workload, trace):\n    return float(workload.attempted())\n")
    monkeypatch.setattr(mmbench.layer_metrics, "__path__", [*mmbench.layer_metrics.__path__, str(pkg)])
    reader = spec.layer_reader("frames_counted")

    class Stub:
        def attempted(self):
            return 12

    assert (reader.UNIT, reader.LAYER, reader.MOVES) == ("frames", "engine", "frame_ms")
    assert reader.read(Stub(), None) == 12.0


def test_every_metric_of_the_benchmark_has_its_reader():
    bench = spec.benchmark()
    names = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        reader = spec.layer_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
        assert set(m["workloads"]) <= names
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["why"] == w["why"] and cell["traffic"]["name"] == w["traffic"]
        assert spec.config(cell["config"])["name"] == w["config"]
        spec.traffic(cell["traffic"]["kind"]).Workload
    for c in bench["configs"]:
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"] and data["reduced"] == c["reduced"]


def test_spans_time_each_call():
    s = tracing.Spans(False)
    for _ in range(3):
        with s.span("tick"):
            pass
    assert len(s.by_name["tick"]) == 3 and s.mean_ms("tick") >= 0.0 and s.mean_ms("present") is None
