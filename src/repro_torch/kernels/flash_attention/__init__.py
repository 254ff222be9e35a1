"""Flash attention: GQA, causal/window masks, logit softcap, decode over a
KV cache (CUDA C++ in ``csrc/``)."""
