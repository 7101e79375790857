"""Per-layer metrics: one module a metric, named as in ``BENCHMARK.json``.

Each declares ``UNIT``, ``LAYER`` (the layer's name in PERF.md's list of layers), ``MOVES``
(the end-to-end metric it should move) and ``read(workload, trace)``, which returns the
metric of a traced run, or None where it finds nothing to read (the harness then leaves it
out of the result).  ``trace`` is a ``tracing.Trace``; the workload's ``spans`` hold the
benchmark's host spans.
"""
