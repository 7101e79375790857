"""Native (C++) host components of the port, loaded with ctypes (``sched``: the
streaming scheduler's core)."""
