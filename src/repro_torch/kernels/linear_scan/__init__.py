"""Chunked gated linear attention (GLA): the Mamba2 and RWKV6 scan (CUDA
C++ in ``csrc/``)."""
