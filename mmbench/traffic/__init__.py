"""Traffic kinds: one module a kind, named by a cell's ``traffic.kind``.

Each module holds a ``Workload`` class built as ``Workload(cell, config, seed, seconds,
spans, device)`` with:
- ``setup()``: everything before the window (the program built, its kernels warmed on the
  shapes the window uses, the world or the inputs made from the seed);
- ``window()``: the measured window (wrapped by the harness in the span ``window``);
- ``end_to_end()``: {metric name: (value, unit)} of the window;
- ``attempted()``: the areas or frames the window started;
- ``release()``: drops what the check and the per-layer readers do not need;
- ``check(precision="f32")``: [(name, value, limit)] of the comparison with the plain
  reference, each value passing when it is at most its limit; ``precision="bf16"`` puts
  the reference computed in bfloat16 in the program's place (the control);
and what its per-layer readers (``mmbench/layer_metrics``) ask of it.
"""

import torch


def sync(device):
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Done:
    """A completion mark after the work queued so far: a CUDA event on the card; on the
    CPU, where each call returns its result, already complete."""

    def __init__(self, device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def synchronize(self):
        if self.event is not None:
            self.event.synchronize()
