"""Repo-root pytest hook: lets the JAX reference package import under jax 0.9.

``repro.core.forecast.register_barrier_batching`` asks
``prim in batching.primitive_batchers``. In jax 0.9 that mapping is a
``PrimitiveBatchersProxy`` with no ``__contains__`` and no ``__iter__``, so the
membership test raises ``TypeError`` and every module that imports
``repro.core`` fails at collection. jax 0.9 already ships the batching rule
for ``optimization_barrier`` (in ``fancy_primitive_batchers``), so answering
the membership test from that mapping makes the guard return early, as it was
written to. Nothing else is changed: no PRNG flag, no other config.

This file is loaded before any test module, so the shim is in place before
anything imports ``repro``.
"""
try:
    from jax._src.interpreters import batching as _batching
except ImportError:  # pragma: no cover - jax absent: nothing to repair
    _batching = None

if _batching is not None and hasattr(_batching, "fancy_primitive_batchers"):
    _proxy = type(_batching.primitive_batchers)
    if "__contains__" not in vars(_proxy):
        _proxy.__contains__ = (
            lambda self, prim: prim in _batching.fancy_primitive_batchers)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written "
        "kernels); skips without one")
