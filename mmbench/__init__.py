"""The benchmark of ``mega_minecraft_tpu_torch`` on one NVIDIA H100.

Run from the root of a checkout:

    python -m mmbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It is driven by data.  ``BENCHMARK.json`` at the root names the cells and the metrics; each
cell is ``mmbench/cells/<name>.json`` (its configuration, its traffic's kind and parameters,
its check's sample sizes and limits, its ``why``); each configuration
``mmbench/configs/<name>.json``; each traffic kind a module ``mmbench/traffic/<kind>.py``;
each per-layer metric a module ``mmbench/layer_metrics/<name>.py``.  A new configuration,
cell or per-layer metric is a new file.  The plain reference that decides ``correct`` is
under ``mmbench/reference``; the roofline arithmetic in ``mmbench/roofline.py``.
"""
