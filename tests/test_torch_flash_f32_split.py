"""A numeric model, in plain torch, of the arithmetic of kernel #4's float32
prefill route (``kernels/flash_attention/csrc/flash_attention.cu``), held
against the JAX package's
``repro.kernels.flash_attention.ref.attention_reference``.

The model does what the kernel does:

* every operand x of S = Q K^T and of O += P V is split by bit operations
  as hi = x rounded to TF32 (10 mantissa bits, to nearest with ties away
  from zero, the bits ``cvt.rna.tf32.f32`` gives) and lo = x - hi, which
  the tensor core reads truncated to TF32;
* each 8-wide k-step is three tensor-core products (``mma``), lo.hi,
  hi.lo, hi.hi (lo.lo is dropped): in S = Q K^T each of the three sums
  over the k-steps apart, then (lo.hi + hi.lo) + hi.hi rounded to nearest;
  in P V the three in that order into a sum over the key tile from zero,
  and O = O alpha + that sum by one rounded FMA;
* an ``mma``'s float32 sum truncates: the model forms its 8 products and
  its accumulator exactly (in float64) and rounds the sum toward zero to
  float32. The card also drops the low bits of the addends it aligns
  before that sum, which the model does not, so its truncation is the
  least the card's can be;
* the online softmax runs in log2 units over the kernel's tiles: 64 query
  rows a block, BN keys a tile by head dim as the source's dispatch sets
  them (read from the source), the tiles outside a block's key span
  skipped;
* P V takes each 8-key tile's keys in the order its A fragment reads them
  (k = t is key 2t, k = t + 4 key 2t + 1: keys 0, 2, 4, 6, 1, 3, 5, 7), V's
  rows in the same order.

The kernel itself runs on the card (``tests/test_torch_kernel_cuda.py``);
here the point is the arithmetic: the split keeps float32's 2e-5 limit
(max abs, the card's limit for the float32 cases) and one TF32 product
does not; and P V summed into O over every key (``pv_sums="all"``, the
route's first design) drifts further from the exact result than the
per-tile sums do. Inputs come from numpy with a seed.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import kernel

torch.set_num_threads(1)

TOL = 2e-5
BM = 64                            # query rows a block
NEG_INF = -1e30
LOG2E = 1.4426950408889634
PERM = [0, 2, 4, 6, 1, 3, 5, 7]    # P V's k = 0..7 as keys of an 8-key tile


def _tiles():
    """(HMAX, BN) of each instance of the source, in dispatch order."""
    src = kernel.SOURCES["flash_attention"].read_text()
    return [(int(h), int(b)) for h, b in
            re.findall(r"run<(\d+), (\d+)>\(a, vec, st\)", src)]


def tf32_rna(x):
    """x rounded to TF32 (low 13 bits cleared), to nearest, ties away from
    zero: half a unit added to the magnitude's bits, then truncated."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """x as the tensor core reads a float32 operand: its low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def trunc_f32(x):
    """float64 x rounded toward zero to float32."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def mma(c, a, b):
    """One tensor-core product a (..., M, 8) b (..., 8, N) + c of TF32
    operands: exact products and sum, truncated to float32; c None is the
    kernel's ``mma_z`` (no accumulator in)."""
    d = a.double() @ b.double()
    return trunc_f32(d if c is None else d + c.double())


def operands(a, b, three=True):
    """The operand pairs of one k-step's products in the kernel's order:
    lo.hi, hi.lo, hi.hi; with ``three`` False only hi.hi (one TF32
    product)."""
    ah, al = split(a)
    bh, bl = split(b)
    return [(al, bh), (ah, bl), (ah, bh)] if three else [(ah, bh)]


def kernel_model(q, k, v, *, causal=True, window=None, softcap=None,
                 q_offset=0, length=None, three=True, pv_sums="tile"):
    """The route's output for float32 q (B, Sq, N, H), k and v (B, Sk, K,
    H). ``pv_sums="all"`` sums P V into O over every key (O = O alpha, then
    the products into it) instead of a key tile's sum from zero."""
    B, Sq, N, H = q.shape
    Sk, K = k.shape[1], k.shape[2]
    BN = next(bn for hmax, bn in _tiles() if H <= hmax)
    HK, nqt, nkt = -(-H // 8) * 8, -(-Sq // BM), -(-Sk // BN)
    kv_len = Sk if length is None else length
    qb = F.pad(q.permute(0, 2, 1, 3), (0, HK - H, 0, nqt * BM - Sq)
               ).reshape(B, N, nqt, BM, HK)
    fold = torch.arange(N) // (N // K)            # query head -> KV head
    kb, vb = (F.pad(x.permute(0, 2, 1, 3), (0, HK - H, 0, nkt * BN - Sk)
                    )[:, fold] for x in (k, v))
    scale = torch.tensor(H ** -0.5, dtype=torch.float32)
    scale_l2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    # each block's key span, as key_span in flash_common.cuh
    qt = torch.arange(nqt)
    q_first = q_offset + qt * BM
    q_last = q_offset + torch.clamp(qt * BM + BM, max=Sq) - 1
    k_end = torch.clamp(q_last + 1, max=kv_len) if causal else \
        torch.full((nqt,), kv_len)
    k_begin = torch.clamp(q_first - window + 1, min=0) if window else \
        torch.zeros(nqt, dtype=torch.long)
    j_begin = k_begin // BN
    j_end = torch.where(k_end > k_begin, -(-k_end // BN), j_begin)
    qpos = (q_offset + torch.arange(nqt * BM)).reshape(nqt, BM, 1)
    m = torch.full((B, N, nqt, BM), NEG_INF)
    l = torch.zeros(B, N, nqt, BM)
    o = torch.zeros(B, N, nqt, BM, HK)
    for j in range(int(j_begin.min()), int(j_end.max())):
        kt = kb[:, :, j * BN:(j + 1) * BN].unsqueeze(2)
        vt = vb[:, :, j * BN:(j + 1) * BN].unsqueeze(2)
        acc = [None] * (3 if three else 1)
        for c in range(0, HK, 8):
            acc = [mma(x, *ab) for x, ab in zip(acc, operands(
                qb[..., c:c + 8], kt[..., c:c + 8].transpose(-1, -2), three))]
        s = acc[0] if len(acc) == 1 else (acc[0] + acc[1]) + acc[2]
        if softcap:
            x = softcap * torch.tanh(s * scale / softcap) * LOG2E
        else:
            x = s * scale_l2
        kpos = j * BN + torch.arange(BN)
        keep = kpos < kv_len
        if causal:
            keep = keep & (kpos <= qpos)
        if window:
            keep = keep & (qpos - kpos < window)
        x = torch.where(keep, x, NEG_INF)
        mx = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x - mx[..., None])
        l_new = l * alpha + p.sum(-1)
        # this tile's P V from zero, then one FMA; or summed into O
        pv = None if pv_sums == "tile" else o * alpha[..., None]
        for c in range(0, BN, 8):
            for ab in operands(p[..., c:c + 8][..., PERM],
                               vt[..., c:c + 8, :][..., PERM, :], three):
                pv = mma(pv, *ab)
        o_new = pv if pv_sums == "all" else (
            o.double() * alpha[..., None].double() + pv.double()).float()
        on = ((j_begin <= j) & (j < j_end))[:, None]  # the block loads tile j
        m, l = torch.where(on, mx, m), torch.where(on, l_new, l)
        o = torch.where(on[..., None], o_new, o)
    out = o * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    return out.reshape(B, N, nqt * BM, HK)[:, :, :Sq, :H].permute(0, 2, 1, 3)


def _qkv(B, Sq, Sk, N, K, H, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, N, H), (B, Sk, K, H), (B, Sk, K, H))]


def _gap(arrs, three=True, **mask):
    got = kernel_model(*(torch.tensor(a) for a in arrs), three=three, **mask)
    want = np.asarray(jref.attention_reference(
        *(jnp.asarray(a) for a in arrs), **mask))
    assert got.shape == want.shape and torch.isfinite(got).all()
    return float(np.abs(got.numpy() - want).max())


def test_tf32_rna_rounds_to_nearest_ties_away_and_splits_to_21_bits():
    one = 1.0 + 2.0 ** -11      # halfway between 1 and 1 + 2^-10
    x = torch.tensor([one, -one, one - 2.0 ** -23, 3.0], dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]
    assert tf32_rna(x).tolist() == want
    x = torch.tensor(np.random.default_rng(0).standard_normal(4096)
                     .astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    assert ((x.double() - hi.double() - lo.double()).abs()
            <= 2.0 ** -21 * x.double().abs()).all()
    assert ((x - hi).abs() > 2.0 ** -14 * x.abs()).any()   # hi alone is not


def test_model_tiles_follow_the_source():
    """The model reads BN from the source's dispatch: one instance up to
    the widest head dim, tiles of whole 16-key pairs."""
    tiles = _tiles()
    assert [h for h, _ in tiles] == sorted(h for h, _ in tiles)
    assert tiles[-1][0] == kernel.MAX_HEAD_DIM
    assert all(bn % 16 == 0 for _, bn in tiles)


MASKS = {
    "causal": dict(causal=True),
    "window + softcap": dict(causal=True, window=40, softcap=30.0),
    "q_offset + length": dict(causal=True, q_offset=100, length=170),
}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("H", (64, 112, 192))
def test_split_tf32_model_matches_jax_reference(H, mask):
    """Ragged query counts (not multiples of 64), GQA (4 query heads on 2
    KV heads); the chunked prefill's 70 queries at positions 100..169 over
    a cache of 200 slots filled to 170; a window of 40 keys."""
    kw = MASKS[mask]
    Sq, Sk = (70, 200) if "length" in kw else (130, 130)
    gap = _gap(_qkv(1, Sq, Sk, 4, 2, H, H + len(mask)), **kw)
    print(f"split TF32 model vs JAX, H={H}, {mask}: {gap:.3e}")
    assert gap < TOL


def test_one_tf32_product_misses_the_limit():
    """Why the split is there: hi.hi alone is ~1e-3 off."""
    arrs = _qkv(1, 130, 130, 4, 2, 64, 7)
    one, three = _gap(arrs, three=False), _gap(arrs)
    print(f"one TF32 product {one:.3e}, split {three:.3e}")
    assert one > 10 * TOL and three < TOL


def test_per_tile_pv_sums_bound_the_truncation():
    """Why P V is summed a key tile at a time: summed into O over all 1,024
    keys, the truncating sums pull every output toward zero (a mean signed
    error of ~-8e-6 of |out|, growing with the keys) and ~10x further from
    the exact result than the per-tile sums, which round once a tile."""
    arrs = _qkv(1, 64, 1024, 2, 2, 64, 0)
    q, k, v = (torch.tensor(a) for a in arrs)
    qd, kd, vd = (x.double().permute(0, 2, 1, 3) for x in (q, k, v))
    want = torch.softmax(qd @ kd.transpose(-1, -2) * 64 ** -0.5, -1) @ vd
    gap, bias = {}, {}
    for mode in ("tile", "all"):
        got = kernel_model(q, k, v, causal=False, pv_sums=mode)
        d = got.double().permute(0, 2, 1, 3) - want
        gap[mode] = d.abs().max().item()
        bias[mode] = (d * want.sign()).mean().item() / want.abs().mean().item()
    print(f"P V per tile {gap['tile']:.3e} (bias {bias['tile']:.3e}), over "
          f"all keys {gap['all']:.3e} (bias {bias['all']:.3e})")
    assert gap["all"] > 5 * gap["tile"] and gap["tile"] < TOL
    assert bias["all"] < 10 * bias["tile"] < 0
