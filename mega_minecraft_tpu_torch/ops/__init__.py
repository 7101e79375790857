"""Plain PyTorch hash and noise primitives (CUDA twins in ``csrc/mmt_math.cuh``)."""
