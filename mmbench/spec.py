"""The benchmark's data: ``BENCHMARK.json``, the cells, the configurations and the per-layer
readers, each found by its name."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> dict:
    path = HERE / "cells" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"mmbench: no cell {name!r} ({path} is missing)")
    data = json.loads(path.read_text())
    if data.get("name") != name:
        raise SystemExit(f"mmbench: {path} names the cell {data.get('name')!r}")
    return data


def config(name: str) -> dict:
    data = json.loads((HERE / "configs" / f"{name}.json").read_text())
    if data.get("name") != name:
        raise SystemExit(f"mmbench: configs/{name}.json names the configuration {data.get('name')!r}")
    return data


def reports(entry: dict, workload: str) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is reported by the cell ``workload``."""
    return "workloads" not in entry or workload in entry["workloads"]


def metrics_of(bench: dict, workload: str):
    """(end-to-end entries, per-layer entries) that the cell reports."""
    return ([m for m in bench["end_to_end"] if reports(m, workload)],
            [m for m in bench["per_layer"] if reports(m, workload)])


def layer_reader(name: str):
    """The module of a per-layer metric: ``UNIT``, ``LAYER``, ``MOVES`` and ``read(ctx)``."""
    return importlib.import_module(f"mmbench.layer_metrics.{name}")


def traffic(kind: str):
    return importlib.import_module(f"mmbench.traffic.{kind}")
