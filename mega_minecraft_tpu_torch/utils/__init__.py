"""Host-side utilities of the port (``profiling``: per-stage timers)."""
