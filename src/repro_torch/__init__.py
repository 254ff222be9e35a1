"""PyTorch/CUDA port of the CICS reproduction (the JAX package ``repro``
stays as the reference it is held against).

``core`` holds the day-cycle pipelines and the staged day, ``sim`` the
scenario library and the batched rollout engine, ``kernels`` the
hand-written Hopper kernels with their plain PyTorch versions, and
``convert`` carries the reference's state across for the parity tests.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
