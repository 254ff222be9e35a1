"""The plain version of the CUDA decode route's split-KV merge: float32
partials (m, l, acc) per key split (``ref.attention_partials``) and their
log-sum-exp merge (``ref.combine_partials``), against the port's
``ref.attention_reference`` and the JAX package's
``repro.kernels.flash_attention.ref.attention_reference``.

The cases cover 1, 2, 3 and 7 splits, splits with no key in range, a cache
length on a split boundary and one key either side of it, a window that
crosses splits, GQA with G = 1, 2 and 4, and softcap. Inputs come from
numpy with a seed. Tolerance: 1e-5 (max abs) in float32; the merge sums
the splits in another order than one softmax over all keys.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import kernel, ref

TOL = 1e-5


def _qkv(B, Sq, Sk, N, K, H, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, N, H), (B, Sk, K, H), (B, Sk, K, H))]
    return [jnp.asarray(a) for a in arrs], [torch.tensor(a) for a in arrs]


def _merged(q, k, v, splits, **kw):
    m, l, acc = ref.attention_partials(q, k, v, splits, **kw)
    B, Sq, N, H = q.shape
    assert m.shape == l.shape == (splits, B, Sq, N)
    assert acc.shape == (splits, B, Sq, N, H)
    out = ref.combine_partials(m, l, acc)
    assert torch.isfinite(out).all()
    return out


def _check(q, k, v, jx, splits, **kw):
    got = _merged(q, k, v, splits, **kw)
    want = ref.attention_reference(q, k, v, **kw)
    jwant = np.asarray(jref.attention_reference(*jx, **kw))
    assert (got - want).abs().max().item() < TOL
    assert np.abs(got.numpy() - jwant).max() < TOL


@pytest.mark.parametrize("splits", (1, 2, 3, 7))
def test_merge_matches_reference(splits):
    """A decode call (one query at 45 over a cache filled to 46)."""
    jx, (q, k, v) = _qkv(2, 1, 80, 4, 2, 32, splits)
    _check(q, k, v, jx, splits, causal=True, q_offset=45, length=46)


@pytest.mark.parametrize("splits", (3, 7))
def test_split_with_no_key_gets_weight_zero(splits):
    """Ten keys in range: at 7 splits of two keys the last two hold none
    and keep m = -1e30, l = 0, acc = 0; the merge stays finite."""
    jx, (q, k, v) = _qkv(1, 1, 40, 4, 2, 16, 11)
    kw = dict(causal=True, window=10, q_offset=30, length=31)
    bounds = ref.split_bounds(splits, Sq=1, Sk=40, **kw)
    assert sum(e - a for a, e in bounds) == 10
    m, l, acc = ref.attention_partials(q, k, v, splits, **kw)
    empty = [i for i, (a, e) in enumerate(bounds) if a >= e]
    assert len(empty) == (2 if splits == 7 else 0)
    for i in empty:
        assert (m[i] == ref.NEG_INF).all()
        assert (l[i] == 0).all() and (acc[i] == 0).all()
    _check(q, k, v, jx, splits, **kw)


def test_no_key_in_range_gives_zeros_not_nan():
    """A window that ends before the cache length leaves every split
    empty: the merge writes zeros."""
    _, (q, k, v) = _qkv(1, 1, 40, 2, 2, 8, 12)
    m, l, acc = ref.attention_partials(q, k, v, 3, causal=False, window=5,
                                       q_offset=30, length=20)
    assert (l == 0).all() and (m == ref.NEG_INF).all()
    out = ref.combine_partials(m, l, acc)
    assert torch.isfinite(out).all() and (out == 0).all()


@pytest.mark.parametrize("length", (63, 64, 65, 127, 128, 129))
def test_length_on_and_beside_a_split_boundary(length):
    """Four splits over a 192-slot cache read to ``length`` by a query
    past its end (masked by length, not causally): 64 and 128 fall on a
    boundary of 16- and 32-key splits, the others one key either side."""
    jx, (q, k, v) = _qkv(2, 1, 192, 4, 4, 32, length)
    _check(q, k, v, jx, 4, causal=True, q_offset=191, length=length)


@pytest.mark.parametrize("splits", (2, 3, 7))
def test_window_across_splits(splits):
    """Four query rows with a 20-key window: each row's window starts in
    another split, and some splits hold no key of some rows."""
    jx, (q, k, v) = _qkv(2, 4, 120, 4, 2, 32, 20 + splits)
    _check(q, k, v, jx, splits, causal=True, window=20, q_offset=96,
           length=100)


@pytest.mark.parametrize("N,K", ((4, 4), (8, 4), (8, 2)))
def test_gqa_groups(N, K):
    """G = N / K = 1, 2 and 4 query heads on one KV head."""
    jx, (q, k, v) = _qkv(2, 2, 90, N, K, 32, N * K)
    _check(q, k, v, jx, 3, causal=True, q_offset=70, length=72)


@pytest.mark.parametrize("splits", (1, 5))
def test_softcap(splits):
    jx, (q, k, v) = _qkv(1, 1, 64, 8, 4, 16, 30 + splits)
    _check(q, k, v, jx, splits, causal=True, softcap=5.0, q_offset=60,
           length=61)


@pytest.mark.parametrize("rows,keys,want", (
    (1, 1041, 3),       # Zamba2-7B decode: B = 4, K = 32
    (2, 1041, 9),       # Qwen3-0.6B decode: B = 4, K = 8, G = 2
    (1, 63, 1),         # under one split's 64 keys
    (1, 130, 2),
))
def test_decode_splits_follow_the_rule(rows, keys, want):
    """The wrapper's split count: about two blocks an SM of a 132-SM card,
    64 keys a split at least."""
    K = 32 if rows == 1 else 8
    assert kernel.decode_splits(4, K, rows, keys, 132) == want
