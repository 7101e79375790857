"""The benchmark's plain reference: a frozen copy of the plain PyTorch stages of the world
generator and the frame path, beside the two drivers that compose them (``chunk.py``,
``frame.py``).

The modules under ``ops/``, ``world/``, ``terrain/``, ``render/``, ``config.py`` and
``tables.py`` are copies of the port's plain versions with every kernel dispatch taken out:
each public stage runs its plain version on whatever device its tensors are on.  They import
nothing of the measured program, so a later change to the program cannot move the
yardstick; the CPU tests in ``mmbench/tests`` hold the copy equal to the port's plain
stages at a tiny size.  The reference reads no environment (no ``MMTPU_*`` override, the
procedural texture atlas).
"""
