"""The trainer's optimizer and gradient compression against the JAX package
on the CPU: ``schedule`` over a warmup-to-decay range, one ``adamw_update``
at steps across that range (both sides fed the same parameters, moments
and gradients, from numpy), and the int8 ``compress`` / ``roundtrip`` with
its error feedback. The reference runs under ``jax.jit``, as its trainer
runs it.

Tolerances: the learning rate, parameters and moments within 1e-6
relative (float32 arithmetic in another order: the global norm sums the
leaves in another order, and XLA's ``pow`` may differ from torch's by an
ulp); the int8 values and per-leaf scales bit for bit; the error-feedback
buffer within 1e-6 of max|g|. The error feedback's unbiasedness is the
property of ``tests/test_properties.py``: over 30 round trips of a
constant gradient the outputs sum to 30 g within 2% of 30 max|g|.
"""
import functools

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import schedule as jschedule
from repro.optim.compression import compress as jcompress
from repro.optim.compression import roundtrip as jroundtrip
from repro_torch.optim import AdamWConfig, adamw_update, schedule
from repro_torch.optim.compression import (compress, decompress,
                                           init_error_feedback, roundtrip)

RTOL = 1e-6
CFG = dict(peak_lr=3e-3, warmup_steps=20, decay_steps=100)
SHAPES = {"embed": (40, 16), "w": (16, 3, 8), "ln": (16,), "b": (5,)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: one intra-op thread (the test workers share the
    cores; more threads only wait on each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _jadamw(master):
    """The reference update under ``jax.jit``, as its trainer runs it (one
    compile, not one per operation)."""
    cfg = JAdamWConfig(**CFG, master=master)
    return jax.jit(lambda p, g, s: jadamw_update(p, g, s, cfg))


def test_schedule_matches_reference():
    steps = np.arange(0, 140, dtype=np.int32)
    want = np.asarray(jschedule(JAdamWConfig(**CFG), jnp.asarray(steps)))
    got = schedule(AdamWConfig(**CFG), torch.tensor(steps)).numpy()
    assert got.dtype == np.float32
    assert _rel(want, got) <= RTOL
    # warmup rises to the peak, the cosine falls to min_lr_ratio x peak
    assert got[0] == 0 and got[20] == pytest.approx(3e-3)
    assert got[-1] == pytest.approx(3e-4)


@pytest.mark.parametrize("master", (False, True))
@pytest.mark.parametrize("step", (0, 7, 19, 20, 63, 99, 130))
def test_adamw_update_matches_reference(step, master):
    """One update from state step ``step`` with random moments: the
    clipped global norm, warmup and cosine, decay only on leaves of two or
    more dimensions, and the float32 master copy when asked."""
    rng = np.random.default_rng(step)
    p, g = _tree(rng), _tree(rng, 3.0)
    m, v = _tree(rng, 0.1), {k: np.abs(x) for k, x in
                             _tree(rng, 0.01).items()}
    cfg = dict(CFG, master=master)
    jstate = {"m": m, "v": v, "step": jnp.asarray(step, jnp.int32)}
    tstate = {"m": _torch(m), "v": _torch(v),
              "step": torch.tensor(step, dtype=torch.int32)}
    if master:
        jstate["master"] = p
        tstate["master"] = _torch(p)
    jp, js, jm = _jadamw(master)(p, g, jstate)
    tp, ts, tm = adamw_update(_torch(p), _torch(g), tstate,
                              AdamWConfig(**cfg))
    assert int(ts["step"]) == step + 1 and ts["step"].dtype == torch.int32
    for k in ("grad_norm", "lr"):
        assert _rel(jm[k], tm[k].item()) <= RTOL, k
    for k in SHAPES:
        assert _rel(jp[k], tp[k].numpy()) <= RTOL, k
        assert _rel(js["m"][k], ts["m"][k].numpy()) <= RTOL, k
        assert _rel(js["v"][k], ts["v"][k].numpy()) <= RTOL, k
        if master:
            assert _rel(js["master"][k], ts["master"][k].numpy()) <= RTOL


def test_adamw_keeps_bf16_params_and_float32_moments():
    p = {"w": torch.randn(4, 4).bfloat16(), "b": torch.randn(4).bfloat16()}
    g = {k: torch.randn_like(x) for k, x in p.items()}
    from repro_torch.optim import init_opt_state
    cfg = AdamWConfig(**CFG)
    new, state, _ = adamw_update(p, g, init_opt_state(p, cfg), cfg)
    assert all(new[k].dtype == torch.bfloat16 for k in p)
    assert all(state[s][k].dtype == torch.float32 for s in ("m", "v")
               for k in p)


def test_compress_matches_reference():
    """Two round trips: from a zero buffer, then from the residual."""
    rng = np.random.default_rng(5)
    g = _tree(rng, 2.0)
    g["ln"][:] = 0.0                      # an all-zero leaf: the 1e-12 floor
    jef = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), g)
    tef = init_error_feedback(_torch(g))
    for _ in range(2):
        (jq, js), jef = jax.jit(jcompress)(g, jef)
        (tq, ts), tef = compress(_torch(g), tef)
        for k in SHAPES:
            assert tq[k].dtype == torch.int8
            np.testing.assert_array_equal(np.asarray(jq[k]), tq[k].numpy())
            assert np.asarray(js[k]).tobytes() == ts[k].numpy().tobytes()
            gmax = max(np.abs(g[k]).max(), 1e-30)
            assert np.abs(np.asarray(jef[k]) - tef[k].numpy()).max() \
                <= 1e-6 * gmax, k
    out, _ = roundtrip(_torch(g), init_error_feedback(_torch(g)))
    want, _ = jax.jit(jroundtrip)(g, jax.tree.map(jnp.zeros_like, g))
    for k in SHAPES:
        np.testing.assert_array_equal(np.asarray(want[k]), out[k].numpy())
    assert decompress(tq, ts).keys() == tq.keys()


@given(seed=st.integers(0, 2**16), scale=st.floats(0.1, 10.0))
@settings(max_examples=25, deadline=None)
def test_error_feedback_unbiased(seed, scale):
    """Over repeated steps with a constant gradient g, the error-feedback
    compressor's cumulative output converges to the true cumulative sum."""
    rng = np.random.RandomState(seed)
    g = {"w": torch.tensor(rng.randn(8, 8).astype(np.float32) * scale)}
    ef = init_error_feedback(g)
    total = torch.zeros_like(g["w"])
    steps = 30
    for _ in range(steps):
        out, ef = roundtrip(g, ef)
        total = total + out["w"]
    rel = float((total - steps * g["w"]).abs().max()) \
        / (float(g["w"].abs().max()) * steps + 1e-9)
    assert rel < 0.02
