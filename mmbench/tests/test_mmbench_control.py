"""The control of each cell on the card, at the cell's own size: the plain reference
computed in bfloat16 (the nearest precision below the configurations' float32) put in the
program's place fails the comparison, on three seeds, while the program passes it.

    python -m pytest -m cuda mmbench/tests/test_mmbench_control.py -s

Each seed is a run of the cell (set-up, a short window at the cell's load) whose check runs
twice: on the program's outputs and on the control's.  ``-s`` prints the readings, from
which PERF.md sets the limits."""

from __future__ import annotations

import pytest
import torch

from mmbench import run

SEEDS = (3300000001, 3300000002, 3300000003)
WINDOW_S = 6.0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["pregen33_featured", "flyloop_540up", "flyloop_1080"])
def test_control_fails_where_the_program_passes(cuda_device, cell):
    for seed in SEEDS:
        _, wl = run.build(cell, seed, WINDOW_S, False, cuda_device)
        run.measure(wl, False)
        wl.release()
        program = wl.check()
        control = wl.check("bf16")
        print(f"{cell} seed {seed}: program " + ", ".join(f"{n} {v!r}" for n, v, _ in program)
              + "; control " + ", ".join(f"{n} {v!r}" for n, v, _ in control), flush=True)
        assert all(v <= lim for _, v, lim in program)
        assert not all(v <= lim for _, v, lim in control)
        del wl
        torch.cuda.empty_cache()
