"""Flash attention (kernel #4's plain version and dispatcher) against the
JAX package: its ``attention_reference``, its chunked path and its Pallas
kernel in interpret mode, over the cases of ``tests/test_kernels_flash.py``
plus decode calls with a runtime ``q_offset`` and cache ``length``. The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_kernel_cuda.py`` and ``chip_smoke.py``.

Tolerances: 2e-5 in float32, 2e-2 in bfloat16 (max abs), the limits
``tests/test_kernels_flash.py`` holds the TPU kernel to. Inputs come from
numpy with a seed; bfloat16 inputs are rounded from the same float32
values on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jkernel
from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import kernel, ops, ref

CASES = [
    # B, Sq, N, K, H, causal, window, softcap, dtype
    (2, 256, 4, 2, 64, True, None, None, "float32"),
    (1, 200, 8, 8, 32, True, None, 50.0, "float32"),
    (2, 128, 4, 1, 64, True, 64, None, "float32"),
    (1, 256, 2, 2, 128, False, None, None, "float32"),
    (1, 192, 6, 3, 64, True, None, None, "float32"),
    (2, 128, 4, 2, 64, True, None, None, "bfloat16"),
    (1, 320, 4, 4, 96, True, 128, 30.0, "float32"),
]
DECODE_CASES = [
    # B, Sk, N, K, H, window, softcap, pos, dtype
    (2, 64, 4, 2, 32, None, None, 17, "float32"),
    (1, 40, 8, 8, 16, 8, 50.0, 33, "float32"),
    (3, 90, 4, 4, 112, None, None, 60, "bfloat16"),
    (2, 50, 16, 8, 128, None, None, 0, "float32"),
]


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 2e-2


def _qkv(B, Sq, Sk, N, K, H, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, N, H), (B, Sk, K, H), (B, Sk, K, H))]
    jx = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _gap(j, t):
    return float(np.abs(np.asarray(j.astype(jnp.float32))
                        - t.float().numpy()).max())


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference_and_interpret_kernel(case):
    B, S, N, K, H, causal, window, softcap, dtype = case
    (jq, jk, jv), (q, k, v) = _qkv(B, S, S, N, K, H, dtype, S + N)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ref.attention_reference(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = jref.attention_reference(jq, jk, jv, **kw)
    pallas = jkernel.flash_attention(jq, jk, jv, qb=64, kb=64,
                                     interpret=True, **kw)
    assert _gap(want, got) < _tol(dtype), case
    assert _gap(pallas, got) < _tol(dtype), case


@pytest.mark.parametrize("q_chunk", (64, 128))
def test_chunked_matches_reference(q_chunk):
    """The bounded-memory path the models take on the CPU, against the
    JAX package's chunked path and the port's own exact version."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 300, 300, 4, 2, 32, "float32", 1)
    got = ref.attention_chunked(q, k, v, causal=True, window=100,
                                q_chunk=q_chunk)
    want = jref.attention_chunked(jq, jk, jv, causal=True, window=100,
                                  q_chunk=q_chunk)
    assert _gap(want, got) < 2e-5
    exact = ref.attention_reference(q, k, v, causal=True, window=100)
    assert (got - exact).abs().max().item() < 1e-5


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_with_runtime_offset_and_length(case):
    """One query at position ``pos`` over a cache filled to ``pos + 1``
    (the call ``apply_gqa_decode`` makes): the port's dispatcher on a CPU
    tensor against the JAX reference."""
    B, Sk, N, K, H, window, softcap, pos, dtype = case
    (jq, jk, jv), (q, k, v) = _qkv(B, 1, Sk, N, K, H, dtype, Sk + pos)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=pos,
              length=pos + 1)
    got = ops.attention(q, k, v, **kw)
    want = jref.attention_reference(jq, jk, jv, **kw)
    assert _gap(want, got) < _tol(dtype), case


def test_decode_length_masking():
    """Cache positions at or past ``length`` do not contribute."""
    _, (q, k, v) = _qkv(2, 1, 64, 4, 4, 32, "float32", 2)
    pos = 17
    o1 = ref.attention_reference(q, k, v, q_offset=pos, length=pos + 1)
    k2, v2 = k.clone(), v.clone()
    k2[:, pos + 1:] = 999.0
    v2[:, pos + 1:] = 999.0
    o2 = ref.attention_reference(q, k2, v2, q_offset=pos, length=pos + 1)
    assert (o1 - o2).abs().max().item() < 1e-6


def test_cpu_tensors_take_the_plain_route():
    """A CPU tensor never reaches the kernel: the launch counter stays
    where it was (0 without a card) and the result is the plain
    version's, the decode call included."""
    _, (q, k, v) = _qkv(1, 40, 40, 4, 2, 16, "float32", 3)
    before = kernel.flash_attention_cuda.launches
    got = ops.attention(q, k, v, causal=True)
    dec = ops.attention(q[:, :1], k, v, q_offset=20, length=21)
    assert kernel.flash_attention_cuda.launches == before
    assert torch.equal(got, ref.attention_chunked(q, k, v, causal=True))
    assert torch.equal(dec, ref.attention_reference(q[:, :1], k, v,
                                                    q_offset=20, length=21))


def test_no_route_for_other_devices():
    q = torch.zeros(1, 2, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no attention route"):
        ops.attention(q, q, q)


@pytest.mark.parametrize("Sq,Sk,mask", [
    (64, 64, dict(causal=True)),
    (64, 64, dict(causal=True, window=9)),
    (50, 50, dict(causal=False)),
    (1, 70, dict(causal=True, q_offset=33, length=34)),
    (1, 70, dict(causal=True, q_offset=33, length=34, window=8)),
])
def test_work_counts_follow_the_mask(Sq, Sk, mask):
    """The bound's pair count is the number of (query, key) pairs the
    plain version's mask leaves; the bytes count the keys some query
    attends."""
    qpos = mask.get("q_offset", 0) + torch.arange(Sq)
    m = ref._mask(qpos, torch.arange(Sk), causal=mask["causal"],
                  window=mask.get("window"), length=mask.get("length"))
    assert kernel.attention_pairs(Sq, Sk, **mask) == int(m.sum())
    assert kernel.attention_flops(2, Sq, Sk, 4, 16, **mask) == \
        4 * 2 * 4 * 16 * int(m.sum())
    keys = int(m.any(0).nonzero().max()) - int(m.any(0).nonzero().min()) + 1
    assert kernel.attention_bytes(2, Sq, Sk, 4, 2, 16, 2, **mask) == \
        2 * (2 * 2 * Sq * 4 * 16 + 2 * 2 * keys * 2 * 16)
