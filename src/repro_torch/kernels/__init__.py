"""Hand-written Hopper kernels, each beside its plain PyTorch version
(``ref.py``) and a dispatcher (``ops.py``) that routes CUDA tensors to the
kernel and CPU tensors to the plain version."""
