"""The fused VCC projected-gradient epoch (CUDA C++ in ``csrc/``)."""
