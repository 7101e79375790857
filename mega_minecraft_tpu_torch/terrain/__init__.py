"""Terrain generation stages: each a plain version plus a CUDA kernel wrapper."""
