"""The port's threefry stream against jax's, key for key and draw for draw.

Keys, splits, fold-ins, raw bits and uniforms must be bitwise equal. Normals
go through an inverse error function: the port evaluates XLA's float32
polynomial with emulated fused multiply-adds and an emulated Cephes log, so
they agree with jax to within 2 ulp (on these draws; in 1e6 draws of one
seed a single draw was seen at 3 ulp, where XLA's log differs by 1 ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = (0, 1, 17, 2**31 - 1)


def _np(x):
    return np.asarray(x).astype(np.int64)


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_stream_is_partitionable():
    # the port follows jax 0.9's default stream; no flag is set here
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bits_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(jk), tk.numpy())
    for num in (2, 3, 10):
        np.testing.assert_array_equal(_np(jax.random.split(jk, num)),
                                      prng.split(tk, num).numpy())
    for data in (0, 1, 17, 999, 2**20):
        np.testing.assert_array_equal(_np(jax.random.fold_in(jk, data)),
                                      prng.fold_in(tk, data).numpy())
    for shape in ((7,), (3, 5), (2, 3, 4)):
        np.testing.assert_array_equal(_np(jax.random.bits(jk, shape)),
                                      prng.random_bits(tk, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (1000,))),
        prng.uniform(tk, (1000,)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (4, 9), minval=-2.0, maxval=3.5)),
        prng.uniform(tk, (4, 9), -2.0, 3.5).numpy())


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_normal_within_2_ulp(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = np.asarray(jax.random.normal(jk, (100_000,)))
    got = prng.normal(tk, (100_000,)).numpy()
    assert _ulp(want, got).max() <= 2


def test_batched_keys_equal_per_key_draws():
    jks = jax.random.split(jax.random.PRNGKey(5), 6)
    tks = prng.split(prng.PRNGKey(5), 6)
    days = np.arange(6)
    # batched fold_in with per-key data, as the day cycle folds in the day
    jf = jax.vmap(jax.random.fold_in)(jks, jnp.asarray(days))
    tf = prng.fold_in(tks, torch.as_tensor(days))
    np.testing.assert_array_equal(_np(jf), tf.numpy())
    batched = prng.normal(tf, (3, 24)).numpy()
    for b in range(6):
        one = prng.normal(tf[b], (3, 24)).numpy()
        np.testing.assert_array_equal(batched[b], one)
        ref = np.asarray(jax.random.normal(jf[b], (3, 24)))
        assert _ulp(ref, one).max() <= 2
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (5,)))(jf)),
        prng.uniform(tf, (5,)).numpy())
    # nested key batches: split of a batch of keys
    np.testing.assert_array_equal(
        _np(jax.vmap(lambda k: jax.random.split(k, 4))(jks)),
        prng.split(tks, 4).numpy())
